"""The plain reference against the port at tiny widths of the cell's
architecture, on the same raw bytes: logits only. This checks the
reference before the card trusts it."""

import numpy as np
import torch

from portbench.reference.ggml import dequant
from portbench.reference.model import Reference
from portbench.tests import tiny
from portbench.weights import build_model, make_checkpoint


def test_reference_logits_equal_the_ports():
    from llm_tpu_torch.session import (InferenceSession,
                                       InferenceSessionConfig,
                                       ModelKVMemoryType, OutputRequest)

    cfg = tiny.FALCON
    ckpt = make_checkpoint(cfg, 2**32 + 17, "cpu")
    model, _ = build_model(cfg, ckpt, "cpu")
    ids = [int(t) for t in np.random.default_rng(5).integers(1, 96, 40)]
    f32 = ModelKVMemoryType.Float32  # the cache adds no rounding here
    sess = InferenceSession(model, InferenceSessionConfig(f32, f32, 16))
    req = OutputRequest(all_logits=[])
    sess.feed_prompt(ids, output_request=req)
    port = np.asarray(req.all_logits, np.float32).reshape(len(ids), -1)
    ref = Reference(ckpt.hp, ckpt.tensors, "cpu").logits(
        [ids], [list(range(len(ids)))])[0].numpy()
    scale = np.abs(ref).max()
    assert scale > 0.1
    assert np.abs(port - ref).max() <= 1e-4 * scale
    assert (port.argmax(-1) == ref.argmax(-1)).all()


def test_dequant_equals_the_ports_decode():
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.ops.packing import decode_plain

    ckpt = make_checkpoint(tiny.FALCON, 99, "cpu")
    for name, (fmt, dims, raw) in ckpt.tensors.items():
        if fmt != "q4_0":
            continue
        K, R = dims
        q, s, b = decode_plain(GgmlType.Q4_0, torch.from_numpy(raw.copy()),
                               K, R)
        assert b is None
        g = K // s.shape[1]
        # the canonical decode keeps the nibble; w = d(q - 8)
        port = (q - 8).float() * s.repeat_interleave(g, 1)
        mine = dequant(fmt, torch.from_numpy(raw.copy()), dims)
        assert torch.equal(mine, port), name


def test_weights_have_a_trained_models_spread():
    ckpt = make_checkpoint(tiny.FALCON, 3, "cpu")
    ref = Reference(ckpt.hp, ckpt.tensors, "cpu")
    for name, (fmt, _, _) in ckpt.tensors.items():
        if fmt == "f32":
            continue
        w = ref.w(name)
        assert 0.01 < float(w.std()) < 0.04
        assert abs(float(w.mean())) < 0.01

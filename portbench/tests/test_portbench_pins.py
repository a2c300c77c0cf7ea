"""What the architecture and format files must not move: the checkpoint's
bytes, the roofline's bounds and the plain reference's logits, pinned to
the values the harness gave before Falcon's and Q4_0's code left its
shared modules (taken on the CPU, as these tests run)."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import plugins
from portbench.roofline import Work, peaks
from portbench.tests import tiny
from portbench.weights import hparams, make_checkpoint

CONFIGS = Path(__file__).resolve().parent.parent / "configs"

# sha256 over every tensor, by name: name|format|dims|bytes
CHECKPOINT = {
    7: "23c8a40a9689dfeaa8199e0315cb7be623c66ba976d94fe4d46c4cc7de96664b",
    2**32 + 17:
        "19a05e0953ae041f6f5c5489222bc8855526db480b84afdda5c4284cf5af0373",
}

# Work.bounds at Falcon-7B's published widths on the H100's peaks
BOUNDS = {"matmul": 0.16272522720726615,
          "decode_attention": 0.0003839040191044776,
          "step": 0.16341776669007127}

# sha256 of the f32 logits of the two sequences below
LOGITS = ["a7b85944bffdfc916c819f1d246a065be7a465bf06a4baaffd7a765df90fff88",
          "db6b26320f932839781699dc9e40e1b048818c18f9c4a4dae74dac4670f33803"]


def checkpoint_digest(ckpt) -> str:
    h = hashlib.sha256()
    for name in sorted(ckpt.tensors):
        fmt, dims, arr = ckpt.tensors[name]
        h.update(f"{name}|{fmt}|{tuple(dims)}|".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(CHECKPOINT))
def test_checkpoint_bytes_are_pinned(seed):
    ckpt = make_checkpoint(tiny.FALCON, seed, "cpu")
    assert checkpoint_digest(ckpt) == CHECKPOINT[seed]


def test_roofline_bounds_are_pinned():
    cfg = json.loads((CONFIGS / "falcon-7b.q4_0.json").read_text())
    shape = plugins.arch(cfg["arch"]).shape_of(cfg, hparams(cfg))
    # two 512-row prompt chunks, then 128 decode steps at n_past 1020-1147
    work = Work(decode=[[p] for p in range(1020, 1148)],
                prefill=[(0, 512), (512, 512)])
    assert work.bounds(shape, peaks("NVIDIA H100 80GB HBM3")) == BOUNDS


def test_reference_logits_are_pinned():
    ckpt = make_checkpoint(tiny.FALCON, 2**32 + 17, "cpu")
    ref = plugins.load("reference", tiny.FALCON["arch"]).Reference(
        ckpt.hp, ckpt.tensors, "cpu")
    ids = [int(t) for t in np.random.default_rng(5).integers(1, 96, 40)]
    got = ref.logits([ids, ids[:17]], [list(range(40)), [3, 16]])
    assert [hashlib.sha256(x.numpy().astype(np.float32).tobytes())
            .hexdigest() for x in got] == LOGITS

"""A configuration of another architecture or block format enters the
harness as new files only. Into a copy of portbench/ the test writes an
architecture (Falcon under a second name, its output head kept in f32),
that architecture's reference and a block format (GGML's Q8_0), and
touches no other file of the copy. A fresh process, importing the copy,
then makes a checkpoint, builds the port's model and runs the plain
reference and the roofline through the new files at a tiny size, holds
the port's logits against that reference, and runs a whole tiny cell."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests import tiny

PB = Path(__file__).resolve().parent.parent
ROOT = PB.parent

ARCH = '''"""Falcon under a second name, its output head kept in f32."""

from portbench import plugins
from portbench.roofline import Cost, Shape

_falcon = plugins.arch("falcon")
PORT_ARCH = _falcon.PORT_ARCH
hparams = _falcon.hparams
port_hparams = _falcon.port_hparams


def tensor_list(hp):
    return [(n, d, "f32") if n == "lm_head.weight" else (n, d)
            for n, d in _falcon.tensor_list(hp)]


class HeadF32(Shape):
    def matmul(self, rows, head_rows):
        head = self.n_embd * self.n_vocab * (32 - self.bits) / 8
        return super().matmul(rows, head_rows) + Cost(0.0, head)


def shape_of(cfg, hp):
    s = _falcon.shape_of(cfg, hp)
    return HeadF32(**vars(s))
'''

REFERENCE = '''"""Falcon's plain reference under the second name."""

from portbench.reference.falcon import Reference  # noqa: F401
'''

FORMAT = '''"""GGML's Q8_0: blocks of 32 weights in 34 bytes, an f16 scale d then
32 int8 q; w = d * q (ggml-quants.c `dequantize_row_q8_0`)."""

import torch

ELEMENTS = 32
BYTES = 34
BITS = BYTES * 8 / ELEMENTS
GGML_TYPE = "Q8_0"


def draw(gen, n, weights, device):
    raw = torch.randint(0, 256, (n, BYTES), dtype=torch.uint8,
                        generator=gen, device=device)
    lo, hi = weights["q8_0_d"]
    d = torch.rand(n, generator=gen, device=device) * (hi - lo) + lo
    raw[:, 0:2] = d.to(torch.float16).view(torch.uint8).view(n, 2)
    return raw


def dequant(raw, K, R):
    b = raw.reshape(R, K // ELEMENTS, BYTES)
    d = b[..., 0:2].contiguous().view(torch.float16).to(torch.float32)
    q = b[..., 2:34].contiguous().view(torch.int8).to(torch.float32)
    return (d * q).reshape(R, K)
'''

NEW = {"archs/falcon_twin.py": ARCH, "reference/falcon_twin.py": REFERENCE,
       "formats/q8_0.py": FORMAT}

SCRIPT = '''
import json

import numpy as np

import portbench
from portbench import plugins
from portbench.roofline import Work, peaks
from portbench.run import run_cell
from portbench.tests import tiny
from portbench.weights import build_model, make_checkpoint
from llm_tpu_torch.session import (InferenceSession, InferenceSessionConfig,
                                   ModelKVMemoryType, OutputRequest)

cfg = {**tiny.FALCON, "name": "falcon-twin-tiny.q8_0", "arch": "falcon_twin",
       "format": "q8_0",
       "weights": {**tiny.FALCON["weights"], "q8_0_d": [0.0002, 0.00035]}}
ckpt = make_checkpoint(cfg, 2**31 + 5, "cpu")
model, _ = build_model(cfg, ckpt, "cpu")
ids = [int(t) for t in np.random.default_rng(5).integers(1, 96, 40)]
f32 = ModelKVMemoryType.Float32
sess = InferenceSession(model, InferenceSessionConfig(f32, f32, 16))
req = OutputRequest(all_logits=[])
sess.feed_prompt(ids, output_request=req)
port = np.asarray(req.all_logits, np.float32).reshape(len(ids), -1)
ref = plugins.load("reference", cfg["arch"]).Reference(
    ckpt.hp, ckpt.tensors, "cpu")
ref_lg = ref.logits([ids], [list(range(len(ids)))])[0].numpy()
wstd = {n: float(ref.w(n).std()) for n, (f, d, _) in ckpt.tensors.items()
        if len(d) == 2}

twin = plugins.arch(cfg["arch"]).shape_of(cfg, ckpt.hp)
plain = plugins.arch("falcon").shape_of(cfg, ckpt.hp)
work = Work(decode=[[p] for p in range(40, 52)], prefill=[(0, 40)])
cell = run_cell(cfg, tiny.INTERACTIVE, tiny.LIMITS, [], 2**31 + 5, 1.0,
                False, "cpu")
print(json.dumps({
    "portbench": portbench.__file__,
    "formats": {n: f for n, (f, _, _) in ckpt.tensors.items()},
    "scale": float(np.abs(ref_lg).max()),
    "max_diff": float(np.abs(port - ref_lg).max()),
    "argmax_equal": bool((port.argmax(-1) == ref_lg.argmax(-1)).all()),
    "weight_std": wstd,
    "bits": twin.bits,
    "head_bytes": twin.matmul(1, 1).bytes - plain.matmul(1, 1).bytes,
    "bounds": work.bounds(twin, peaks("NVIDIA H100 80GB HBM3")),
    "correct": cell["correct"], "checks": cell["checks"]}))
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy_with_plugins(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(PB, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy)
    for rel, text in NEW.items():
        assert not (copy / rel).exists()
        (copy / rel).write_text(text)
    after = _digests(copy)
    changed = {k for k in after if before.get(k) != after[k]}
    assert changed == set(NEW) and set(before) <= set(after)
    return copy, after


def test_a_plug_in_is_new_files_only(copy_with_plugins):
    copy, digests = copy_with_plugins
    env = {**os.environ, "PYTHONDONTWRITEBYTECODE": "1",
           "PYTHONPATH": os.pathsep.join([str(copy.parent), str(ROOT)])}
    run = subprocess.run([sys.executable, "-c", SCRIPT], cwd=copy.parent,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])

    assert Path(got["portbench"]).parent == copy  # the copy ran
    fmts = got["formats"]
    assert fmts.pop("lm_head.weight") == "f32"
    assert {f for n, f in fmts.items() if n.endswith(("_layernorm.weight",
            "_layernorm.bias", "ln_f.weight", "ln_f.bias"))} == {"f32"}
    assert {f for n, f in fmts.items() if "layernorm" not in n
            and "ln_f" not in n} == {"q8_0"}
    stds = got["weight_std"]
    # an f32 tensor is norm_std times normal noise, a block its format's
    assert stds.pop("lm_head.weight") == pytest.approx(0.05, rel=0.05)
    for name, std in stds.items():
        assert 0.01 < std < 0.04, name

    assert got["scale"] > 0.1
    assert got["max_diff"] <= 1e-4 * got["scale"]
    assert got["argmax_equal"]

    assert got["bits"] == 34 * 8 / 32
    assert got["head_bytes"] == (tiny.FALCON["hidden_size"]
                                 * tiny.FALCON["vocab_size"] * (32 - 8.5) / 8)
    assert 0 < got["bounds"]["matmul"] < got["bounds"]["step"]

    assert got["correct"], got["checks"]
    assert _digests(copy) == digests  # running wrote nothing into it

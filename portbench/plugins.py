"""The harness's plug-in files, each found by the name that a
configuration, a traffic mix or BENCHMARK.json gives:

- `archs/<arch>.py`, an architecture (the configuration's `arch`):
  `hparams(cfg)`, `tensor_list(hp)`, `PORT_ARCH`, `port_hparams(hp)` and
  `shape_of(cfg, hp)`;
- `reference/<arch>.py`, its plain reference: `Reference(hp, tensors,
  device, precision)`;
- `formats/<fmt>.py`, a GGML block format (the configuration's `format`,
  or a tensor's own): `ELEMENTS`, `BYTES`, `BITS`, `GGML_TYPE`,
  `draw(gen, n, weights, device)` and `dequant(raw, K, R)`;
- `metrics/<metric>.py`, a metric's `read(run)`;
- `drivers/<driver>.py`, a traffic mix's `Driver`.

So a configuration of another architecture or format, a metric or a mix
enters as new files, and no file that is there changes.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


@functools.cache
def load(folder: str, name: str):
    """The module portbench/<folder>/<name>.py, executed once."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {folder} plug-in {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arch(name: str):
    return load("archs", name)


def fmt(name: str):
    return load("formats", name)

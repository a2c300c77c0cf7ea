"""What the compiler made of the tensor-core qmatmul kernel, on the machine
that has nvcc (the card's).

1. Registers, shared memory and spills of every kernel instantiation of
   `csrc/qmatmul.cu`, `csrc/qmatmul_probe.cu` and `csrc/paged_attention.cu`
   (`nvcc -Xptxas -v`), by kernel, format, layout and path.
2. The SASS instructions the producer's dequant spends a weight: two
   kernels are compiled from `csrc/qmatmul_tc.cuh`, one that runs
   `dequant_unit` (32 weights a thread) on a packed tile in shared memory
   and one that stores four 16-byte chunks of the packed tile where the
   dequant stores its bf16 ones; the difference of their instruction counts
   (`cuobjdump -sass`), over 32, is the dequant's count a weight (its loads
   and arithmetic, less four 16-byte shared loads).
3. The SASS instructions of one pass of the main loop (a 64 x 128 weight
   tile, 32 weights a thread) of the q4_0 kernels: the production ones of
   `csrc/qmatmul.cu` (`qmm_swapped` on each swapped consumer path, and
   `qmm_wgmma` at 64-128 and at 256 tokens a block, over both layouts),
   and the chip probes' instantiations of `csrc/qmatmul_probe.cu`: each cut
   (stream, unpack, dequant) on P2's paths (8 tokens a block and the wide
   path at 256, planes) and P1's (8 tokens a block, coalesced), and each
   dequant mode of P3 (8 tokens a block, coalesced).
4. The tensor-core instructions of the wide path's kernels (`qmm_wgmma`:
   HGMMA, and no HMMA) and of the attention kernel's GQA branch
   (`gqa_mma`: HMMA), with their registers and spills.

    python -m llm_tpu_torch.probes.kernel_report [--out DIR]

It prints one JSON line; the compiler's own output goes to DIR (default
build/report/).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

from llm_tpu_torch import _build

# (name, Fmt template arguments) of the formats the SASS count covers
SASS_FORMATS = {
    "q4_0": "4, 0, true, 8, 32, false, true",
    "q4_k": "4, 0, false, 0, 32, true, false",
    "q8_0": "8, 0, false, 0, 32, false, true",
    "q6_k": "4, 2, false, 32, 16, false, false",
}

_PROBE_SRC = """\
#include "{header}"
using namespace tc;
// DQ: dequantize the packed tile; else only copy it in and the bf16 tile out
template <class F, bool COAL, bool DQ>
__device__ void body(const uint4* __restrict__ pk_g, uint4* __restrict__ out) {{
  using T = Tile<F, COAL>;
  __shared__ __align__(128) char pk[T::BYTES];
  __shared__ __align__(128) char wt[BN * BK * 2];
  for (int i = threadIdx.x; i < T::BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(pk)[i] = pk_g[i];
  __syncthreads();
  const int c = threadIdx.x & (BN - 1), u = threadIdx.x >> 7;
  if constexpr (DQ) {{
    dequant_unit<F, COAL>(pk, c, u, wt);
  }} else {{  // the same four 16-byte stores, of packed words
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(wt + swz(c, 4 * u + i)) =
          reinterpret_cast<const uint4*>(pk)[(c * 8 + 4 * u + i) %
                                             (T::BYTES / 16)];
  }}
  __syncthreads();
  for (int i = threadIdx.x; i < BN * BK * 2 / 16; i += THREADS)
    out[i] = reinterpret_cast<const uint4*>(wt)[i];
}}
{instances}
"""

_INSTANCE = """\
extern "C" __global__ void __launch_bounds__(THREADS)
    {name}(const uint4* pk, uint4* out) {{ body<Fmt<{fmt}>, {coal}, {dq}>(pk, out); }}"""


def _nvcc(jobs: dict) -> dict:
    """Run one nvcc a job ({name: (arguments, log file)}), all started
    together; their output by name."""
    procs = {n: subprocess.Popen([_build._nvcc(), *args],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, (args, _) in jobs.items()}
    outs = {}
    for n, p in procs.items():
        outs[n] = p.communicate()[0]
        jobs[n][1].write_text(outs[n])
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{outs[n][-4000:]}")
    return outs


def _demangle(names: list) -> dict:
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        r = subprocess.run([tool], input="\n".join(names), capture_output=True,
                           text=True, timeout=60)
        return dict(zip(names, r.stdout.splitlines()))
    except OSError:
        return {n: n for n in names}


def ptxas_table(text: str) -> list:
    """[{kernel, registers, smem_bytes, spill_stores, spill_loads}] from
    `-Xptxas -v` output."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    names = _demangle([r["kernel"] for r in rows])
    for r in rows:
        r["kernel"] = names.get(r["kernel"], r["kernel"])
    return rows


def sass_listing(text: str) -> dict:
    """{kernel (mangled): [(address, opcode, branch target or None)]} of
    `cuobjdump -sass` output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*)", line)
        if m and cur is not None:
            op = m.group(3).split(".")[0]
            t = re.search(r"\b0x([0-9a-f]+)\b", m.group(4)) \
                if op == "BRA" else None
            cur.append((int(m.group(1), 16), op,
                        int(t.group(1), 16) if t else None))
    return funcs


def _sass(cubin: Path) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    funcs = sass_listing(text)
    names = _demangle(list(funcs))
    return {names.get(k, k): v for k, v in funcs.items()}


def sass_counts(cubin: Path) -> dict:
    """{demangled kernel: Counter of SASS opcodes} of a cubin."""
    return {k: Counter(op for _, op, _ in ins)
            for k, ins in _sass(cubin).items()}


def main_loop(ins: list) -> Counter:
    """The opcodes of a kernel's main loop: the longest body of a backward
    branch that holds a barrier (BAR), one pass of it; empty if none."""
    best = Counter()
    for addr, op, target in ins:
        if op != "BRA" or target is None or target >= addr:
            continue
        body = Counter(o for a, o, _ in ins if target <= a <= addr)
        if body["BAR"] and sum(body.values()) > sum(best.values()):
            best = body
    return best


# the q4_0 (f16-packed scales) instantiations whose main loop is counted:
# {name: (library, demangled-name piece)}, one pass of 64 k x 128 columns,
# 32 weights a thread. The template arguments past the layout are the
# tokens a block (8-token tiles; on the wide path 64-row tiles a
# warpgroup: 1 at 64 or 128 tokens a block, 2 at 256), the stage
# (csrc/qmatmul_tc.cuh Stage: 0 the kernel, 1-3 a cut) and, on the swapped
# path, the mode (Mode: 0 K1's).
_Q4_0 = ("tc::Fmt<(int)4, (int)0, (bool)1, (int)8, (int)32, (bool)0, "
         "(bool)1>")
_LAYOUTS = (("planes", 0), ("coalesced", 1))
_CUTS = (("stream", 1), ("unpack", 2), ("dequant", 3))
_MODES = ("base", "bf16", "f32dot", "ghoist", "noscale", "nounpack")


def _swapped(coal: int, nt: int, stage: int = 0, mode: int = 0) -> str:
    return (f"tc::qmm_swapped<{_Q4_0}, (bool){coal}, (int){nt}, "
            f"(int){stage}, (int){mode}>")


def _wide(coal: int, mi: int, stage: int = 0) -> str:
    return f"tc::qmm_wgmma<{_Q4_0}, (bool){coal}, (int){mi}, (int){stage}>"


LOOP_KERNELS = {
    **{f"{path}_{lay}": ("qmatmul", _swapped(c, nt))
       for path, nt in (("swapped8", 1), ("swapped16", 2))
       for lay, c in _LAYOUTS},
    **{f"wide_mi{mi}_{lay}": ("qmatmul", _wide(c, mi))
       for mi in (1, 2) for lay, c in _LAYOUTS},
    **{f"{cut}_swapped8_{lay}": ("qmatmul_probe", _swapped(c, 1, st))
       for cut, st in _CUTS for lay, c in _LAYOUTS},
    **{f"{cut}_wide_mi2_planes": ("qmatmul_probe", _wide(0, 2, st))
       for cut, st in _CUTS},
    **{f"mode_{m}": ("qmatmul_probe", _swapped(1, 1, 0, i))
       for i, m in enumerate(_MODES)},
}
# the kernels whose tensor-core instructions are counted: (library, name
# piece, the instruction they must hold, the one they must not)
TC_KERNELS = {"qmm_wgmma": ("qmatmul", "tc::qmm_wgmma<", "HGMMA", "HMMA"),
              "gqa_mma": ("paged_attention", "::gqa_mma<", "HMMA", "HGMMA")}


def main_loops(sass: dict) -> dict:
    """Instructions of one pass of each LOOP_KERNELS main loop, in all and
    a weight (32 a thread), by opcode; `sass` maps a library to its
    `_sass` listing. Where the compiler unrolled the loop, its body holds
    several passes: a pass has two barriers on the swapped path and one on
    the wide path, and the counts are divided by the passes found."""
    res = {}
    for name, (lib, piece) in LOOP_KERNELS.items():
        hits = [ins for k, ins in sass[lib].items() if piece in k]
        if len(hits) != 1:
            res[name] = {"error": f"{len(hits)} kernels match {piece}"}
            continue
        loop = main_loop(hits[0])
        passes = max(1, loop["BAR"] // (1 if "qmm_wgmma<" in piece else 2))
        n = sum(loop.values()) / passes
        res[name] = {"instructions": n, "per_weight": n / 32,
                     "passes_in_body": passes,
                     "by_opcode": {k: v / passes
                                   for k, v in loop.most_common()}}
    return res


def tensor_core_ops(sass: dict, ptxas: list, piece: str, want: str,
                    never: str) -> dict:
    """HGMMA and HMMA counts, registers and spills of every kernel whose
    demangled name holds `piece`; `ok`: each holds `want` and no `never`."""
    regs = {r["kernel"]: r for r in ptxas}
    rows = []
    for k, ins in sass.items():
        if piece not in k:
            continue
        ops = Counter(op for _, op, _ in ins)
        r = regs.get(k, {})
        rows.append({"kernel": k, "HGMMA": ops["HGMMA"], "HMMA": ops["HMMA"],
                     "registers": r.get("registers"),
                     "spill_stores": r.get("spill_stores"),
                     "spill_loads": r.get("spill_loads")})
    return {"kernels": rows,
            "ok": bool(rows) and all(r[want] > 0 and r[never] == 0
                                     for r in rows),
            "max_registers": max((r["registers"] or 0 for r in rows),
                                 default=0),
            "spills": sum((r["spill_stores"] or 0) + (r["spill_loads"] or 0)
                          for r in rows)}


CASES = [(f, lay) for f in SASS_FORMATS for lay in ("planes", "coalesced")
         if lay == "planes" or f == "q8_0"]


def dequant_source(out: Path) -> Path:
    """The two kernels a case of CASES, written to out/dequant_only.cu."""
    insts = [_INSTANCE.format(name=f"{kind}_{f}_{lay}", fmt=SASS_FORMATS[f],
                              coal=str(lay == "coalesced").lower(),
                              dq=str(kind == "dq").lower())
             for f, lay in CASES for kind in ("dq", "base")]
    src = out / "dequant_only.cu"
    src.write_text(_PROBE_SRC.format(
        header=str(_build.CSRC / "qmatmul_tc.cuh"),
        instances="\n".join(insts)))
    return src


def dequant_sass(cubin: Path) -> dict:
    """SASS instructions a weight of `dequant_unit`, by format, over planes
    (and coalesced, where the producer differs: q8_0)."""
    counts = sass_counts(cubin)
    res = {}
    for f, lay in CASES:
        dq, base = counts[f"dq_{f}_{lay}"], counts[f"base_{f}_{lay}"]
        diff = dq - base
        res[f"{f}_{lay}"] = {
            "instructions_per_weight":
                (sum(dq.values()) - sum(base.values())) / 32,
            "by_opcode_per_weight": {k: v / 32 for k, v in
                                     sorted(diff.items(),
                                            key=lambda kv: -kv[1])},
        }
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=_build.BUILD_DIR.parent / "report")
    args = ap.parse_args(argv)
    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    flags = _build.NVCC_FLAGS[:4]
    jobs = {name: ([*flags, "-Xptxas", "-v", "-cubin", "-o",
                    str(out / f"{name}.cubin"),
                    str(_build.CSRC / f"{name}.cu")], out / f"{name}.log")
            for name in ("qmatmul", "qmatmul_probe", "paged_attention")}
    jobs["dequant_only"] = ([*flags, "-cubin", "-o",
                             str(out / "dequant_only.cubin"),
                             str(dequant_source(out))],
                            out / "dequant_only.log")
    logs = _nvcc(jobs)
    res = {"ptxas": {n: ptxas_table(logs[n])
                     for n in ("qmatmul", "qmatmul_probe",
                               "paged_attention")},
           "dequant_sass": dequant_sass(out / "dequant_only.cubin"),
           "main_loop_sass": main_loops(
               {lib: _sass(out / f"{lib}.cubin")
                for lib in ("qmatmul", "qmatmul_probe")})}
    res["tensor_core_sass"] = {
        name: tensor_core_ops(_sass(out / f"{lib}.cubin"), res["ptxas"][lib],
                              piece, want, never)
        for name, (lib, piece, want, never) in TC_KERNELS.items()}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

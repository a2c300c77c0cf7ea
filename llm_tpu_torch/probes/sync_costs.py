"""What one pass of each synchronisation step of the wide qmatmul kernel's
k-tile loop costs on the card, alone: clock64 cycles a loop iteration of a
block of 256 threads (one a SM), each step repeated 4000 times.

The steps: `__syncthreads`, `fence.proxy.async.shared::cta` (generic
stores before a wgmma reads them), `wgmma.wait_group 1` with nothing in
flight, an mbarrier arrival and its `try_wait` (plain, and by
`cp.async.mbarrier.arrive.noinc`), a shared store with the fence and a
barrier, and a 16-byte cp.async from global memory with its wait and a
barrier. A k-tile of `csrc/qmatmul_tc.cuh`'s wide path runs about six of
these in series.

    python -m llm_tpu_torch.probes.sync_costs [--out DIR]

Needs nvcc and the card; the source is written to DIR (default
build/report/) and built there. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from llm_tpu_torch import _build

STEPS = ["syncthreads", "fence_proxy_async", "wgmma_wait_group_1",
         "cp_async_arrive_noinc_try_wait", "arrive_try_wait",
         "sts_fence_syncthreads", "cp_async_global_wait_syncthreads"]

_SRC = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t su(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void wait(uint32_t b, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 "
                 "p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(b), "r"(parity) : "memory");
}
__global__ void k(long long* out, const float* g, int mode, int iters) {
  __shared__ __align__(16) uint64_t bar[32];
  __shared__ __align__(16) float buf[1024];
  const int tid = threadIdx.x;
  if (tid == 0)
    for (int i = 0; i < 32; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(su(&bar[i])), "r"(256));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const uint32_t b = su(&bar[i & 31]), parity = (i >> 5) & 1;
    if (mode == 0) {
      __syncthreads();
    } else if (mode == 1) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    } else if (mode == 2) {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    } else if (mode == 3) {
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                   :: "r"(b) : "memory");
      wait(b, parity);
    } else if (mode == 4) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(b)
                   : "memory");
      wait(b, parity);
    } else if (mode == 5) {
      buf[(tid * 4 + i) & 1023] = (float)i;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    } else {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   :: "r"(su(&buf[tid * 4])), "l"(g + (tid & 63) * 4));
      asm volatile("cp.async.commit_group;");
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
    }
  }
  if (tid == 0) out[blockIdx.x] = clock64() - t0;
}
int main() {
  long long* d;
  float* g;
  cudaMalloc(&d, 132 * sizeof(long long));
  cudaMalloc(&g, 4096);
  cudaMemset(g, 0, 4096);
  for (int m = 0; m < 7; ++m) {
    k<<<132, 256>>>(d, g, m, 1000);  // warm
    k<<<132, 256>>>(d, g, m, 4000);
    const cudaError_t e = cudaDeviceSynchronize();
    long long h[132];
    cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
    double sum = 0;
    for (int i = 0; i < 132; ++i) sum += h[i];
    printf("%d %.1f %d\n", m, sum / 132 / 4000, (int)e);
  }
  return 0;
}
"""


def parse(text: str) -> dict:
    """{step: cycles a pass} from the binary's `mode cycles error` lines."""
    out = {}
    for line in text.splitlines():
        m = re.fullmatch(r"(\d+) ([\d.]+) (\d+)", line.strip())
        if m:
            if int(m.group(3)):
                raise RuntimeError(f"step {STEPS[int(m.group(1))]}: "
                                   f"cudaError_t {m.group(3)}")
            out[STEPS[int(m.group(1))]] = float(m.group(2))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=_build.BUILD_DIR.parent / "report")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    src, exe = args.out / "sync_costs.cu", args.out / "sync_costs"
    src.write_text(_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:4], "-o", str(exe),
                    str(src)], check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=120)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "cycles_a_pass": parse(run.stdout)}),
          flush=True)


if __name__ == "__main__":
    main()

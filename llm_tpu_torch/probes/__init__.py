"""Chip probes of the qmatmul kernel: where its time goes on the card.

    python -m llm_tpu_torch.probes.kernel_decompose   # P2: scalar K1 by stage
    python -m llm_tpu_torch.probes.dequant_variants   # P3: dequant arithmetic
    python -m llm_tpu_torch.probes.coalesced          # P1: layouts and tilings

Each runs on the card (`--device cuda`, the default) at the reference
probe's 7B geometry, prints its table and then one JSON line; `--device
cpu` runs the plain versions at a tiny size (a test of the entry point,
no timing). `python -m llm_tpu_torch.probes.kernel_report` (needs nvcc)
reports what the compiler made of the kernels: registers, spills, SASS;
`python -m llm_tpu_torch.probes.sync_costs` (needs nvcc and the card)
what each synchronisation step of the wide path's k-tile loop costs.
"""

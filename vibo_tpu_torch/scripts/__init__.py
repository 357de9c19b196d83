"""Scripts of the port (counterparts of the repo's `scripts/` at-scale
pipeline), each run as `python -m vibo_tpu_torch.scripts.<name>`:

- `gen_duolingo_csv`: a DuoLingo-shaped learning-traces CSV from a seed;
- `bench_ingest`: the native C++ CSV parser against the Python path;
- `run_at_scale`: raw CSV -> native ingest -> person split -> fused packed
  2PL training -> blocked evaluation and amortized new-person scoring.

Importing a module runs nothing."""

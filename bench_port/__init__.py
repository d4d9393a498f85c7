"""The benchmark of wfsim_tpu_torch (see BENCHMARK.json and PERF.md)."""

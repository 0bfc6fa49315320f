"""The benchmark of ircl_tpu_torch (see BENCHMARK.json and run.py)."""

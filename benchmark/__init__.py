"""The benchmark of ``icpflow_tpu_torch`` on one NVIDIA GPU: see README.md."""

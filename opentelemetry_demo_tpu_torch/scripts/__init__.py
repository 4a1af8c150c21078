"""The port's command-line counterparts of the repository's ``scripts/``:
run each as ``python -m opentelemetry_demo_tpu_torch.scripts.<name>``."""

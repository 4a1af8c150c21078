"""``python -m opentelemetry_demo_tpu_torch`` runs the anomaly-detector
daemon (runtime.daemon) on the card; ``--device cpu`` runs it on the
plain PyTorch path.

``main()`` runs only when the package is executed: importing this module
boots nothing."""

from .runtime.daemon import main

if __name__ == "__main__":
    main()

"""Probes of the port that run as `python -m udifftext_tpu_torch.scripts.<name>`."""

"""Experiments on the card, run as modules: ``python -m options_model_tpu_torch.scripts.<name>``."""

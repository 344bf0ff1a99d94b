"""Command-line entry points, as options_model_tpu/apps: so far the
calibration app (``python -m options_model_tpu_torch.apps.calibrate``) and
the IV-surface training app (``python -m
options_model_tpu_torch.apps.train_surface``)."""

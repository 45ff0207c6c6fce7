"""Offline tools of the port, each run as ``python -m
wesup_tpu_torch.scripts.<name>``: weak labels (``generate_points``),
``area.csv`` (``generate_area``), the contest evaluations
(``evaluate_glas``, ``evaluate_crag``, ``evaluate_pdl1``) and the timing
of the trainer's host-metrics val phase (``measure_eval_metrics``).
They read and write images through ``data/codec.py`` and need neither
OpenCV, pandas nor joblib."""

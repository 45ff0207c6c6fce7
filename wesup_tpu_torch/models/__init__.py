"""Model layer of the port: VGG16 backbone, WESUP module, objectives,
the train, eval and predict steps, and the trainer."""


def initialize_trainer(model_type, device=None, **kwargs):
    """Map a model name to its trainer (reference models/__init__.py:9-19).

    ``device`` is the reference CLIs' ``device`` option (reference
    train.py:30) and takes the place of the JAX package's ``platform=``:
    ``None`` trains on the card and raises without one, ``"cpu"`` trains
    on the host."""
    if model_type == "wesup":
        from .trainer import WESUPTrainer

        return WESUPTrainer(device=device, **kwargs)
    raise ValueError(f"Unsupported model: {model_type}")

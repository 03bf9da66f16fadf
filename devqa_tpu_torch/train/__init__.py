from .loop import EditorTrainer, TrainableEditor  # noqa: F401

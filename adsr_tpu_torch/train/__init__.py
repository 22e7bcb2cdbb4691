"""Training (the SR trainer and its losses, EfficientAD and its teacher
distillation) and the serving forwards."""

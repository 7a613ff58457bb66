from .trainer import KerasAdam, Trainable, fit, keras_adam

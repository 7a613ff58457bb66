from .batching import batches
from .core import Forward, Layer, Network, ParamSpec
from .initializers import init_param
from .layers import (LSTM, Activation, Branch, Concatenate, Dense, Dropout,
                     Resume, Tradeoff, Wrap)

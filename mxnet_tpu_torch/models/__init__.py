"""Model families of the PyTorch port."""

from . import ssd
from .lenet import get_symbol as lenet
from .transformer import TransformerLM, param_names, transformer_lm

__all__ = ["TransformerLM", "param_names", "transformer_lm", "lenet", "ssd"]

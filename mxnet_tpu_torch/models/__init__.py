"""Model families of the PyTorch port."""

from .transformer import TransformerLM, param_names

__all__ = ["TransformerLM", "param_names"]

"""Model families of the PyTorch port, and ``get_symbol``, the network
factory of ``mxnet_tpu/models/__init__.py`` (``_FACTORY``)."""

from ..base import MXNetError, not_ported
from . import ssd
from .lenet import get_symbol as lenet
from .mlp import get_symbol as mlp
from .resnet import get_symbol as resnet
from .transformer import TransformerLM, param_names, transformer_lm

__all__ = ["TransformerLM", "param_names", "transformer_lm", "lenet", "mlp",
           "resnet", "ssd", "get_symbol"]

_FACTORY = {
    "mlp": mlp,
    "lenet": lenet,
    "resnet": resnet,
    "transformer-lm": transformer_lm,
    "transformer_lm": transformer_lm,
}
# the JAX package's other image families: their ops (LRN, Dropout,
# Concat-heavy inception blocks) come with queue A item 2
_NOT_PORTED = ("alexnet", "vgg", "inception-bn", "inception_bn",
               "inception-v3", "inception_v3")


def get_symbol(name, **kwargs):
    """The network ``name`` (reference: example/image-classification/
    train_model.py): ``resnet-N`` is ``resnet(num_layers=N)``."""
    if name.startswith("resnet"):
        if "-" in name and name != "resnet":
            return resnet(num_layers=int(name.split("-")[1]), **kwargs)
        return resnet(**kwargs)
    if name in _NOT_PORTED:
        raise not_ported(f"models.get_symbol({name!r}) (queue A item 2)")
    if name not in _FACTORY:
        raise MXNetError(f"unknown network {name!r}; known: "
                         f"{sorted(_FACTORY)} and resnet-N")
    return _FACTORY[name](**kwargs)

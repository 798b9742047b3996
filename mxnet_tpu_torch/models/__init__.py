"""Model families of the PyTorch port, and ``get_symbol``, the network
factory of ``mxnet_tpu/models/__init__.py`` (``_FACTORY``)."""

from ..base import MXNetError
from . import ssd
from .alexnet import get_symbol as alexnet
from .inception_bn import get_symbol as inception_bn
from .inception_v3 import get_symbol as inception_v3
from .lenet import get_symbol as lenet
from .mlp import get_symbol as mlp
from .resnet import get_symbol as resnet
from .transformer import TransformerLM, param_names, transformer_lm
from .vgg import get_symbol as vgg

__all__ = ["TransformerLM", "param_names", "transformer_lm", "lenet", "mlp",
           "alexnet", "vgg", "resnet", "inception_bn", "inception_v3", "ssd",
           "get_symbol"]

_FACTORY = {
    "mlp": mlp,
    "lenet": lenet,
    "alexnet": alexnet,
    "vgg": vgg,
    "resnet": resnet,
    "inception-bn": inception_bn,
    "inception_bn": inception_bn,
    "inception-v3": inception_v3,
    "inception_v3": inception_v3,
    "transformer-lm": transformer_lm,
    "transformer_lm": transformer_lm,
}


def get_symbol(name, **kwargs):
    """The network ``name`` (reference: example/image-classification/
    train_model.py): ``resnet-N`` is ``resnet(num_layers=N)``."""
    if name.startswith("resnet"):
        if "-" in name and name != "resnet":
            return resnet(num_layers=int(name.split("-")[1]), **kwargs)
        return resnet(**kwargs)
    if name not in _FACTORY:
        raise MXNetError(f"unknown network {name!r}; known: "
                         f"{sorted(_FACTORY)} and resnet-N")
    return _FACTORY[name](**kwargs)

"""PyTorch (NCHW) counterparts of ``ssde_tpu.models``: the modules that
GRU v10 streaming inference runs."""

from .common import Conv3x3, ConvBlock, ResidualConvUnit
from .depth_decoder import DepthDecoder
from .fusion import GRUFusionBlock_v2, UpscalePS
from .recurrent import ConvGRUBlocks, ConvGRUCell, RecurrentUnit, make_gru
from .resnet import ResnetEncoder

"""PyTorch (NCHW) counterparts of ``ssde_tpu.models``: the modules that
GRU v9 and v10 streaming inference and sequence training and the mono train
step run."""

from .attention import AttentionConv, AttentionStem, ResidualAttentionUnit
from .common import Conv3x3, ConvBlock, ResidualConvUnit
from .depth_decoder import DepthDecoder
from .fusion import GRUFusionBlock_v2, UpscalePS
from .pose import PoseDecoder
from .recurrent import ConvGRUBlocks, ConvGRUCell, RecurrentUnit, make_gru
from .resnet import ResnetEncoder

"""PyTorch (NCHW) counterparts of ``ssde_tpu.models``: the modules that
the recurrent family's (GRU v1-v10) streaming inference and sequence
training, the mono train step and the 3-frame fusion models' serving run."""

from .attention import AttentionConv, AttentionStem, ResidualAttentionUnit
from .common import Conv3x3, ConvBlock, ResidualConvUnit
from .depth_decoder import DepthDecoder
from .fusion import (FeatureFusionBlock, FeatureFusionBlock_v2, FeatureFusionBlock_v3, Fusion,
                     Fusion_v3, GRUFusionBlock, GRUFusionBlock_v2, UpscalePS)
from .pose import PoseDecoder
from .recurrent import (ConvGRUBlocks, ConvGRUCell, ConvLSTMCell, Head, RecurrentUnit,
                        make_gru)
from .resnet import ResnetEncoder

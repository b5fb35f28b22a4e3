"""PyTorch (NCHW) counterparts of ``ssde_tpu.models``: the modules that
the recurrent family's (GRU v1-v10) streaming inference and sequence
training, the mono train step (with the ResNet or the attention encoder,
and every pose network), the DPT-hybrid's train step and the 3-frame
fusion models run."""

from .attention import AttentionConv, AttentionStem, ResidualAttentionUnit
from .attention_resnet import (AttentionBottleneck, AttentionResNet, AttentionResNet18,
                               AttentionResNet26, AttentionResNet38, AttentionResNet50,
                               ResnetEncoderAttention)
from .common import Conv3x3, ConvBlock, ResidualConvUnit
from .depth_decoder import DepthDecoder
from .dpt import DPTDepthModel, get_mean_attention_map
from .fusion import (FeatureFusionBlock, FeatureFusionBlock_v2, FeatureFusionBlock_v3, Fusion,
                     Fusion_v3, GRUFusionBlock, GRUFusionBlock_v2, UpscalePS)
from .pose import PoseCNN, PoseDecoder
from .recurrent import (ConvGRUBlocks, ConvGRUCell, ConvLSTMCell, Head, RecurrentUnit,
                        make_gru)
from .resnet import ResnetEncoder

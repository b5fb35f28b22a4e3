"""DPT attention panel (counterpart of ``ssde_tpu/viz.py``; reference
util/misc.py:5-63).

``visualize_attention`` draws the input, the prediction and the mean
attention maps of transformer blocks 3, 6, 9 and 12 for the upper-left and
lower-right query tokens. matplotlib is imported when it is called, so
training never needs it; without matplotlib (the GPU machine has none) it
raises ``ImportError``. No trainer calls it.
"""

from __future__ import annotations

import numpy as np

from .models.dpt import get_mean_attention_map

_HYBRID_LAYERS = (3, 6, 9, 12)  # reference util/misc.py:18 (dpt_hybrid)


def visualize_attention(image, attention, prediction, grid_hw, save_path=None):
    """Panel of corner-token attention maps.

    Args:
      image: (3, H, W) array or tensor in [0, 1] (an NCHW frame, batch
        stripped).
      attention: {"attn_1".."attn_4"} of (B, heads, N+1, N+1) maps, as
        ``DPTDepthModel(..., capture_attention=True)`` returns them.
      prediction: (H, W) depth or disparity to show beside them.
      grid_hw: (gh, gw), the token grid (H // 16, W // 16).
      save_path: write the figure there instead of showing it.
    """
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("visualize_attention draws with matplotlib, which is not "
                          "installed here") from e
    if save_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def host(a):
        return a.detach().float().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)

    plt.figure(figsize=(12, 8))
    plt.subplot(3, 4, 1)
    plt.imshow(host(image).transpose(1, 2, 0))
    plt.title("Input", fontsize=8)
    plt.axis("off")
    plt.subplot(3, 4, 2)
    plt.imshow(host(prediction))
    plt.set_cmap("inferno")
    plt.title("Prediction", fontsize=8)
    plt.axis("off")
    for row, (corner, token) in enumerate((("Upper left corner", 1),
                                           ("Lower right corner", -1))):
        for i, key in enumerate(("attn_1", "attn_2", "attn_3", "attn_4")):
            ax = plt.subplot(3, 4, 5 + 4 * row + i)
            ax.imshow(host(get_mean_attention_map(attention[key], token, grid_hw))[0])
            if row == 0:
                ax.set_title(f"Layer {_HYBRID_LAYERS[i]}", fontsize=8)
            if i == 0:
                ax.set_ylabel(corner, fontsize=8)
            ax.set_xticks([])
            ax.set_yticks([])
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, dpi=120)
        plt.close()
    else:
        plt.show()

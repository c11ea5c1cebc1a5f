"""Export LPIPS-VGG16 weights to the .npz that ``utils.image_metrics.lpips_np`` reads
from ``$DMNERF_LPIPS_WEIGHTS`` (``dmnerf_tpu/tools/export_lpips_weights.py``).

The reference scores LPIPS with the ``lpips`` package over torchvision's pretrained
VGG16 features. Those weights are downloaded, so none ship here; convert them once on
a host that has either of:

  * ``lpips`` and ``torchvision`` with their pretrained weights cached:
        python -m dmnerf_tpu_torch.tools.export_lpips_weights out.npz
  * a saved ``lpips.LPIPS(net='vgg')`` state_dict and a torchvision
    ``vgg16().features`` state_dict (needs only torch):
        python -m dmnerf_tpu_torch.tools.export_lpips_weights out.npz \\
            --lpips-state lpips.pt --vgg-state vgg.pt

then set ``$DMNERF_LPIPS_WEIGHTS`` to the file.

.npz schema (all float32):
  conv{i}_w : [3, 3, c_in, c_out]  HWIO kernels of the 13 VGG16 convs, i = 0..12 in
              feature order (conv1_1 .. conv5_3)
  conv{i}_b : [c_out]              their biases
  lin{i}_w  : [c_i]                LPIPS's learned per-channel weights of tap i, i = 0..4
              over relu{1_2, 2_2, 3_3, 4_3, 5_3} (the 1x1 Conv2d(c, 1, bias=False)
              kernels, squeezed)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# channel widths of the 13 VGG16 convs, feature order
VGG16_CONV_CH = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
TAP_CH = [64, 128, 256, 512, 512]  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
# the convs' indices in torchvision's vgg16().features (an nn.Sequential)
CONV_SEQ_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0)).astype(np.float32)


def convert_state_dicts(vgg_features_sd: dict, lpips_sd: dict) -> dict:
    """The .npz's arrays from a torchvision ``vgg16().features`` state_dict (keys
    '0.weight', '2.weight', ... in nn.Sequential order) and an ``lpips.LPIPS(net='vgg')``
    state_dict (keys 'lin{k}.model.1.weight', or 'lins.{k}.model.1.weight' in other
    lpips versions). Raises ValueError on a width off the schema, KeyError on a missing
    tap."""
    out = {}
    for i, si in enumerate(CONV_SEQ_IDX):
        w = np.asarray(vgg_features_sd[f"{si}.weight"])
        b = np.asarray(vgg_features_sd[f"{si}.bias"])
        if w.shape[0] != VGG16_CONV_CH[i]:
            raise ValueError(f"conv {i}: want {VGG16_CONV_CH[i]} output channels, got {w.shape}")
        out[f"conv{i}_w"] = _oihw_to_hwio(w)
        out[f"conv{i}_b"] = b.astype(np.float32)
    for k in range(5):
        for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if key in lpips_sd:
                lw = np.asarray(lpips_sd[key])       # [1, C, 1, 1]
                break
        else:
            raise KeyError(f"lin{k} weight not found in lpips state_dict")
        out[f"lin{k}_w"] = lw.reshape(-1).astype(np.float32)
        if out[f"lin{k}_w"].shape[0] != TAP_CH[k]:
            raise ValueError(f"lin{k}: want {TAP_CH[k]} channels, got {lw.shape}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", help="output .npz path")
    ap.add_argument("--lpips-state", help="torch.save'd lpips.LPIPS(net='vgg') state_dict")
    ap.add_argument("--vgg-state", help="torch.save'd torchvision vgg16().features state_dict")
    args = ap.parse_args(argv)

    import torch

    if args.lpips_state and args.vgg_state:
        vgg_sd = torch.load(args.vgg_state, map_location="cpu")
        lp_sd = torch.load(args.lpips_state, map_location="cpu")
    else:
        try:
            import lpips
            import torchvision
        except ImportError as e:
            print(f"error: {e}; either install lpips+torchvision (with cached "
                  "pretrained weights) or pass --lpips-state/--vgg-state", file=sys.stderr)
            return 1
        vgg_sd = torchvision.models.vgg16(weights="IMAGENET1K_V1").features.state_dict()
        lp_sd = lpips.LPIPS(net="vgg").state_dict()

    vgg_sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in vgg_sd.items()}
    lp_sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in lp_sd.items()}
    np.savez(args.out, **convert_state_dicts(vgg_sd, lp_sd))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

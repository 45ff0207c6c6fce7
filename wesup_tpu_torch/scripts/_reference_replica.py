"""A torch replica of the original reference's WESUP training math, for
``quality_headtohead``.

The reference itself needs torchvision, skimage and albumentations, which
the card's machine does not have, so the head-to-head holds the port
against this replica instead: the reference forward (models/wesup.py:
182-304: VGG16 hooks, side convs, bilinear hypercolumn, superpixel
pooling by a row-normalised assignment matrix, MLP, softmax), its
cross-entropy (models/wesup.py:66-96) and its label propagation
(models/wesup.py:99-139), written from the reference's semantics with
no code of the port.  A copy of ``tests/test_model.py``'s
``_build_torch_vgg``, ``_TorchWESUP`` and ``tests/test_loss.py``'s
``_torch_semi_ce`` and ``_torch_propagate`` (``tests/
test_torch_port_quality_headtohead.py`` holds the copy to them bitwise),
except that the weights come from the port's state dict and every
tensor made here follows its inputs' device.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import vgg
from ..models.wesup import _side_conv_names


def build_vgg():
    """torchvision vgg16().features equivalent, built from the config."""
    layers, in_ch = [], 3
    for c in vgg.VGG16_CFG:
        if c == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers.append(nn.Conv2d(in_ch, c, 3, padding=1))
            layers.append(nn.ReLU(inplace=False))
            in_ch = c
    return nn.Sequential(*layers)


class ReferenceWESUP(nn.Module):
    """Replication of the reference WESUP forward (models/wesup.py:
    182-304)."""

    def __init__(self, n_classes=2, D=32):
        super().__init__()
        self.backbone = build_vgg()
        self.side = nn.ModuleList([
            nn.Conv2d(c, c // 2, 1) for c in vgg.CONV_CHANNELS
        ])
        self.fc_layers = nn.Sequential(
            nn.Linear(vgg.FM_CHANNELS_SUM, 1024), nn.ReLU(),
            nn.Linear(1024, 1024), nn.ReLU(),
            nn.Linear(1024, D), nn.ReLU(),
        )
        self.classifier = nn.Sequential(nn.Linear(D, n_classes),
                                        nn.Softmax(dim=1))

    def forward(self, x, sp_maps):
        fm_size = x.shape[-2:]
        taps = []
        h = x
        conv_i = 0
        for layer in self.backbone:
            if isinstance(layer, nn.Conv2d):
                h = layer(h)
                side_out = self.side[conv_i](h)
                side_out = F.interpolate(side_out, fm_size, mode="bilinear",
                                         align_corners=True)
                taps.append(side_out)
                conv_i += 1
            else:
                h = layer(h)
        hyper = torch.cat(taps, dim=1)  # (1, 2112, H, W)
        flat = hyper.flatten(2).squeeze(0)  # (2112, HW)
        pooled = sp_maps @ flat.t()  # (K, 2112), sp_maps row-normalized
        feats = self.fc_layers(pooled)
        return self.classifier(feats), feats


def copy_weights(state_dict, model: ReferenceWESUP) -> None:
    """The port's WESUP state dict into the replica (copies)."""
    convs = [m for m in model.backbone if isinstance(m, nn.Conv2d)]
    for conv, ti in zip(convs, vgg.TORCH_CONV_INDICES):
        conv.weight.data = state_dict[f"backbone.{ti}.weight"].clone()
        conv.bias.data = state_dict[f"backbone.{ti}.bias"].clone()
    for conv, name in zip(model.side, _side_conv_names()):
        conv.weight.data = state_dict[f"{name}.weight"].clone()
        conv.bias.data = state_dict[f"{name}.bias"].clone()
    for layer, name in ((model.fc_layers[0], "fc_layers.0"),
                        (model.fc_layers[2], "fc_layers.2"),
                        (model.fc_layers[4], "fc_layers.4"),
                        (model.classifier[0], "classifier.0")):
        layer.weight.data = state_dict[f"{name}.weight"].clone()
        layer.bias.data = state_dict[f"{name}.bias"].clone()


def semi_ce(y_hat, y_true, class_weights=None, epsilon=1e-7):
    """Reference _cross_entropy math (models/wesup.py:66-96)."""
    y_hat = torch.clamp(y_hat, min=epsilon, max=1 - epsilon)
    labeled = (y_true.sum(dim=1) > 0).float().sum()
    if labeled.item() == 0:
        return torch.tensor(0.0, device=y_hat.device)
    ce = -y_true * torch.log(y_hat)
    if class_weights is not None:
        ce = ce * torch.as_tensor(class_weights, device=ce.device).float(
        ).unsqueeze(0)
    return ce.sum() / labeled


def propagate(features, y_l, threshold):
    """Reference _label_propagate math (models/wesup.py:99-139): features
    are ordered labeled-first; y_l has the labeled rows only."""
    n_l = y_l.shape[0]
    diff = features.unsqueeze(0) - features.unsqueeze(1)
    W = torch.exp(-(diff * diff).sum(-1))
    W_ul = W[n_l:, :n_l]
    max_sim, src = W_ul.max(dim=1)
    y_u = torch.zeros(features.shape[0] - n_l, y_l.shape[1],
                      device=features.device)
    sel = max_sim > threshold
    y_u[sel] = y_l[src[sel]]
    return y_u

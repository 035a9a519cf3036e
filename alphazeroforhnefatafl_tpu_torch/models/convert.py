"""Flax parameters of ``alphazeroforhnefatafl_tpu.models.network`` as a
``state_dict`` of :class:`..network.PolicyValueNet`.

Conv kernels go from HWIO to OIHW, Dense kernels from ``[in, out]`` to
``Linear.weight [out, in]``, GroupNorm ``scale``/``bias`` to
``weight``/``bias``, and ``skip_gain`` carries over. The policy conv has a
bias only in the norm-free trunk.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv(tree, prefix, out):
    out[prefix + ".weight"] = np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in tree:
        out[prefix + ".bias"] = np.asarray(tree["bias"])


def _dense(tree, prefix, out):
    out[prefix + ".weight"] = np.asarray(tree["kernel"]).T
    out[prefix + ".bias"] = np.asarray(tree["bias"])


def _gn(tree, prefix, out):
    out[prefix + ".weight"] = np.asarray(tree["scale"])
    out[prefix + ".bias"] = np.asarray(tree["bias"])


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params``: the Flax tree (``{"params": ...}`` or its inner dict) with
    numpy leaves. Returns a float32 ``state_dict``."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    norm_free = "NFResBlock_0" in p or "GroupNorm_0" not in p
    _conv(p["Conv_0"], "stem", out)
    i = 0
    while f"{'NFResBlock' if norm_free else 'ResBlock'}_{i}" in p:
        blk = p[f"{'NFResBlock' if norm_free else 'ResBlock'}_{i}"]
        _conv(blk["Conv_0"], f"blocks.{i}.conv0", out)
        _conv(blk["Conv_1"], f"blocks.{i}.conv1", out)
        if norm_free:
            out[f"blocks.{i}.skip_gain"] = np.asarray(blk["skip_gain"])
        else:
            _gn(blk["GroupNorm_0"], f"blocks.{i}.gn0", out)
            _gn(blk["GroupNorm_1"], f"blocks.{i}.gn1", out)
        i += 1
    if not norm_free:
        _gn(p["GroupNorm_0"], "stem_gn", out)
        _gn(p["GroupNorm_1"], "policy_gn", out)
    _conv(p["Conv_1"], "policy_conv", out)
    _conv(p["Conv_2"], "policy_out", out)
    _conv(p["Conv_3"], "value_conv", out)
    _dense(p["Dense_0"], "value_fc", out)
    _dense(p["Dense_1"], "value_out", out)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}

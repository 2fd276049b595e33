"""Diversity-Networks pruning ([26], the paper authors' companion work):
DPP-select a diverse subset of FFN hidden units in a trained block and fuse
the rest, shrinking d_ff while preserving function better than magnitude
pruning at matched sparsity. The steps of ``examples/prune_ffn_dpp.py``,
through the PyTorch port: the same key gives the JAX package's params, and
the DPP's greedy MAP is one launch of the fused greedy-MAP kernel on the
card.

    PYTHONPATH=src python examples/port/prune_ffn_dpp.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import dpp
from repro_torch import random as prng
from repro_torch.configs import smoke_config
from repro_torch.models import LM
from repro_torch.models.common import rms_norm, swiglu
from repro_torch.models.transformer import dense_ffn


def run(cfg=None, probe=(4, 64), params=None, device: str = "cuda") -> dict:
    """The example's steps for ``cfg`` (default qwen2-0.5b's smoke config)
    on ``device``: layer 0's FFN of ``params`` (default
    ``LM(cfg).init_params(PRNGKey(0))``), probed by a seeded float32 batch
    of ``probe`` = (B, S) token positions. Prints what the JAX example
    prints and returns its values, the unit kernel L and the MAP's picks
    in their order, and ``mse(idx)``, the reconstruction error of keeping
    the units ``idx``."""
    cfg = cfg if cfg is not None else smoke_config("qwen2-0.5b")
    lm = LM(cfg, device=device)
    if params is None:
        params = lm.init_params(prng.PRNGKey(0, device))

    # activations of layer-0 FFN hidden units on probe data; the JAX
    # example's float32 probe promotes its products to float32, so the
    # layer's params are read in float32
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (*probe, cfg.d_model)).astype(np.float32)).to(lm.device)
    p_ffn = {k: v[0].to(torch.float32)
             for k, v in params["blocks"]["head"]["layer0"]["ffn"].items()}
    h = rms_norm(x, p_ffn["ln"], cfg.norm_eps)
    acts = swiglu(h @ p_ffn["w_gate"], h @ p_ffn["w_up"])       # (B,S,f)
    A = acts.reshape(-1, cfg.d_ff)

    keep = cfg.d_ff // 2
    # DPP model over hidden units: normalized activation similarity kernel
    An = A / (torch.linalg.norm(A, dim=0, keepdim=True) + 1e-6)
    L = An.T @ An + 1e-4 * torch.eye(cfg.d_ff, device=lm.device)
    units = dpp.from_kernel(L, device=lm.device)
    picks = units.map(keep)
    dpp_idx = np.sort(picks.cpu().numpy())

    # magnitude baseline
    mag_idx = np.sort(torch.argsort(torch.linalg.norm(A, dim=0),
                                    stable=True)[-keep:].cpu().numpy())

    def prune(idx):
        idx = torch.from_numpy(idx).to(lm.device)
        q = dict(p_ffn)
        q["w_gate"] = p_ffn["w_gate"][:, idx]
        q["w_up"] = p_ffn["w_up"][:, idx]
        q["w_down"] = p_ffn["w_down"][idx, :]
        return q

    ref = dense_ffn(p_ffn, x, cfg)

    def mse(idx) -> float:
        return float(torch.mean((dense_ffn(prune(idx), x, cfg) - ref) ** 2))

    err_dpp, err_mag = mse(dpp_idx), mse(mag_idx)
    print(f"pruned d_ff {cfg.d_ff} -> {keep}")
    print(f"reconstruction MSE: DPP-diverse {err_dpp:.5f} vs magnitude "
          f"{err_mag:.5f}")
    print("diverse" if err_dpp <= err_mag else "magnitude",
          "selection wins on this probe")
    return {"keep": keep, "kernel": L, "map_picks": picks,
            "dpp_idx": dpp_idx, "mag_idx": mag_idx, "err_dpp": err_dpp,
            "err_mag": err_mag, "mse": mse}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; fails without a card) or "cpu"')
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()

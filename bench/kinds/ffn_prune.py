"""DPP pruning of an FFN's hidden units (Diversity Networks), one client in
a closed loop.

Traffic parameters: ``probe`` (the positions of a probe batch, (B, S)),
``keep_fraction`` (units kept), ``checked`` (requests the check judges,
drawn from the seed among the window's), ``limits``.

Set-up: every layer's RMSNorm scale and gate and up projections
(``inputs.ffn_weights``) and one probe batch a layer (``inputs.ffn_probes``),
from the seed. Request i prunes layer l = i mod layers on probe l: the
port's ``rms_norm`` and ``swiglu`` give the units' activations A (in
float32), the unit kernel L = ÂᵀÂ + 1e-4 I of the unit-normed columns
(as ``examples/port/prune_ffn_dpp.py`` builds it), then
``dpp.from_kernel(L).map(keep)``, the picks copied to host memory.

Check: the plain reference builds each judged request's unit kernel from
the same weights and probe in float64 (``reference.ffn``) and judges the
picks along their order (``reference.greedy_map.judge``).
"""

from __future__ import annotations

from typing import List

import torch

from .. import inputs
from ..harness import Check, Context
from ..reference import ffn as ref_ffn
from ..reference import greedy_map as ref_map
from ..roofline import requests


class Workload:
    def __init__(self, ctx: Context):
        from repro_torch import dpp
        from repro_torch.models.common import rms_norm, swiglu
        self.ctx, self.dpp = ctx, dpp
        self.rms_norm, self.swiglu = rms_norm, swiglu
        cfg, tr = ctx.config, ctx.traffic
        self.layers = int(cfg["num_hidden_layers"])
        self.d_model = int(cfg["hidden_size"])
        self.d_ff = int(cfg["intermediate_size"])
        self.eps = float(cfg["rms_norm_eps"])
        self.keep = int(self.d_ff * float(tr["keep_fraction"]))
        self.probe = tuple(tr["probe"])
        self.ln, self.w = inputs.ffn_weights(ctx.seed, self.layers,
                                             self.d_model, self.d_ff,
                                             ctx.device)
        self.x = inputs.ffn_probes(ctx.seed, self.layers, self.probe,
                                   self.d_model, ctx.device)

    def warm_up(self) -> None:
        for i in range(2):
            self.call(i)

    def call(self, i: int) -> dict:
        l = i % self.layers
        h = self.rms_norm(self.x[l], self.ln[l], self.eps)
        A = self.swiglu(h @ self.w[l, 0], h @ self.w[l, 1]) \
            .reshape(-1, self.d_ff)
        An = A / (torch.linalg.norm(A, dim=0, keepdim=True) + 1e-6)
        L = An.T @ An
        L.diagonal().add_(1e-4)
        picks = self.dpp.from_kernel(L, device=self.ctx.device).map(self.keep)
        with self.ctx.span("bench.copy_to_host"):
            picks = picks.cpu()
        return {"i": i, "units": 1, "layer": l, "map_size": self.d_ff,
                "picks": picks}

    def flops(self, rec: dict) -> float:
        positions = 1
        for s in self.probe:
            positions *= int(s)
        live = int((rec["picks"] >= 0).sum())
        return requests.ffn_prune(positions, self.d_model, self.d_ff,
                                  self.keep, live)

    def release(self) -> None:
        pass

    def control(self, requests: int, precision: str):
        """The plain reference in the port's place, in float32 with every
        matrix product at ``precision``: ``requests`` requests' records,
        as ``call`` gives them."""
        out = []
        for i in range(requests):
            l = i % self.layers
            L = ref_ffn.unit_kernel(self.x[l], self.ln[l], self.w[l, 0],
                                    self.w[l, 1], self.eps, torch.float32,
                                    precision)
            picks = ref_map.select(L, self.keep, precision).cpu()
            out.append({"i": i, "units": 1, "layer": l,
                        "map_size": self.d_ff, "picks": picks})
        return out

    def check(self, kept: List[dict], last) -> List[Check]:
        gap = 0.0
        for rec in kept:
            l = rec["layer"]
            L = ref_ffn.unit_kernel(self.x[l], self.ln[l], self.w[l, 0],
                                    self.w[l, 1], self.eps)
            gap = max(gap, ref_map.judge(L, rec["picks"].to(L.device))["gap"])
            del L
        lim = self.ctx.traffic["limits"]
        return [Check("map_gap", gap, float(lim["map_gap"])),
                Check("unjudged", float(not kept), 0.0)]

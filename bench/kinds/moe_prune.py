"""DPP pruning of every expert's units of a mixture-of-experts layer
(Diversity Networks, per expert), one client in a closed loop.

Configuration: a published DeepSeek-V3-style ``config.json``'s keys
(``hidden_size``, ``moe_intermediate_size``, ``n_routed_experts``,
``num_experts_per_tok``, ``n_shared_experts``, ``scoring_func``,
``topk_method``, ``n_group``, ``topk_group``, ``norm_topk_prob``,
``routed_scaling_factor``, ``rms_norm_eps``, ``num_hidden_layers``,
``first_k_dense_replace``). Traffic parameters: ``documents`` and
``positions`` (a probe's shape), ``topics`` (the Zipf-skewed topics the
documents are drawn from), ``keep_fraction`` (units kept), ``checked``
(requests the check judges), ``limits`` and ``tie_tolerance``.

Set-up: every MoE layer's weights that choosing units needs
(``inputs_moe.moe_weights``: norm scale, router, correction bias, routed
and shared gate and up projections) and one probe a layer
(``inputs_moe.moe_probes``), from the seed; the warm-up prunes every
layer once (each routes its own way, so its expert products have shapes
of their own). Request i prunes MoE layer
first_k_dense_replace + (i mod the MoE layers) on that layer's probe:
``repro_torch.models.prune.prune_moe_layer`` (route, every expert's
activations on its routed rows, the unit kernels, one batched greedy MAP
for the routed experts and one for the shared), the picks, the experts'
loads copied to host memory in one copy (the routing stays on the
device, for the check).

Check, for each judged request, against the plain reference
(``reference.moe``, float64, the same weights and probe):

- ``route_mismatch``: the (token, expert) pairs the port routes and the
  reference does not, at every token whose reference margin between the
  K-th and the (K+1)-th biased score exceeds ``tie_tolerance`` (closer
  calls are ties that float32 cannot decide), plus the pairs by which the
  port's loads differ from its own routing's;
- ``map_gap``: the widest step gap of the 64 + 1 selections, each judged
  on the float64 unit kernel built on the port's (so verified) routing,
  steps past the kernel's rank counted as ties (``reference.moe.judge``);
- ``unjudged``: 1 when no request was judged.
"""

from __future__ import annotations

from typing import List

import torch

from .. import faults_moe  # noqa: F401  (enters this kind's faults)
from .. import inputs_moe
from ..harness import Check, Context
from ..reference import greedy_map as ref_map
from ..reference import moe as ref_moe
from ..roofline import moe_prune


def model_config(config: dict):
    """The port's ``ModelConfig`` of the MoE layers of a DeepSeek-V3-style
    ``config.json``."""
    from repro_torch.config import ModelConfig
    c = config
    return ModelConfig(
        name=c["name"], family="moe", n_layers=int(c["num_hidden_layers"]),
        d_model=int(c["hidden_size"]),
        n_heads=int(c["num_attention_heads"]),
        n_kv_heads=int(c["num_key_value_heads"]),
        d_ff=int(c["moe_intermediate_size"]), vocab=int(c["vocab_size"]),
        norm_eps=float(c["rms_norm_eps"]),
        n_experts=int(c["n_routed_experts"]),
        experts_per_token=int(c["num_experts_per_tok"]),
        n_shared_experts=int(c["n_shared_experts"]),
        router_scoring=str(c["scoring_func"]),
        norm_topk_prob=bool(c["norm_topk_prob"]),
        routed_scaling=float(c["routed_scaling_factor"]),
        n_group=int(c["n_group"]), topk_group=int(c["topk_group"]),
        dtype="float32", param_dtype="float32")


class Workload:
    def __init__(self, ctx: Context):
        # first, so that a program without it fails at once
        from repro_torch.models.prune import prune_moe_layer
        self.prune = prune_moe_layer
        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = model_config(cfg)
        self.routing = ref_moe.Routing.of(cfg)
        self.first = int(cfg["first_k_dense_replace"])
        self.layers = int(cfg["num_hidden_layers"]) - self.first
        self.d_model = self.cfg.d_model
        self.d_shared = self.cfg.n_shared_experts * self.cfg.d_ff
        self.keep = float(tr["keep_fraction"])
        self.positions = int(tr["documents"]) * int(tr["positions"])
        self.w = inputs_moe.moe_weights(
            ctx.seed, self.layers, self.d_model, self.cfg.n_experts,
            self.cfg.d_ff, self.d_shared, ctx.device)
        if cfg["topk_method"] != "noaux_tc":
            # only noaux_tc routing has a correction bias
            del self.w["router_bias"]
        self.x = inputs_moe.moe_probes(
            ctx.seed, self.layers, int(tr["documents"]),
            int(tr["positions"]), int(tr["topics"]), self.d_model,
            ctx.device)

    def params(self, l: int) -> dict:
        return {k: v[l] for k, v in self.w.items()}

    def warm_up(self) -> None:
        # every layer once: each routes its probe its own way, so each
        # gives the expert products shapes of its own
        for i in range(self.layers):
            self.call(i)

    def _record(self, i: int, l: int, out: dict) -> dict:
        rec = {"i": i, "units": 1, "layer": self.first + l,
               "expert_size": self.cfg.d_ff,
               "expert_picks": out["routed"],
               "tokens_per_expert": out["tokens_per_expert"],
               "routed_rows": int(out["top_e"].numel()),
               "rows_computed": int(out["rows_computed"]),
               "top_e": out["top_e"]}
        if "shared" in out:
            rec["shared_size"] = self.d_shared
            rec["shared_picks"] = out["shared"]
        return rec

    def call(self, i: int) -> dict:
        l = i % self.layers
        out = self.prune(self.params(l), self.x[l], self.cfg, self.keep)
        with self.ctx.span("bench.copy_to_host"):
            # the picks and the loads in one copy; the routing stays on the
            # device for the check
            parts = [out["routed"].reshape(-1),
                     out["tokens_per_expert"].to(torch.int32)]
            if "shared" in out:
                parts.append(out["shared"])
            host = torch.cat(parts).cpu().split([p.numel() for p in parts])
        out["routed"] = host[0].view(out["routed"].shape)
        out["tokens_per_expert"] = host[1]
        if "shared" in out:
            out["shared"] = host[2]
        return self._record(i, l, out)

    def flops(self, rec: dict) -> float:
        return moe_prune.flops(rec, self.positions, self.d_model,
                               self.cfg.n_experts)

    def release(self) -> None:
        pass

    def control(self, requests: int, precision: str):
        """The plain reference in the port's place, in float32 with every
        matrix product at ``precision``: ``requests`` requests' records,
        as ``call`` gives them."""
        out = []
        f32 = torch.float32
        for i in range(requests):
            l = i % self.layers
            p, x = self.params(l), self.x[l].reshape(-1, self.d_model)
            h = ref_moe.rms_norm(x, p["ln"], self.cfg.norm_eps, f32)
            _, _, top_e, _ = ref_moe.route(h, p["router"],
                                           p.get("router_bias"),
                                           self.routing, precision)
            keep = int(self.cfg.d_ff * self.keep)
            routed = torch.stack([
                ref_map.select(L, keep, precision) for _, L in
                ref_moe.expert_unit_kernels(x, p, self.routing,
                                            self.cfg.norm_eps, top_e, f32,
                                            precision)])
            Ls = ref_moe.shared_unit_kernel(x, p, self.cfg.norm_eps, f32,
                                            precision)
            shared = ref_map.select(Ls, int(self.d_shared * self.keep),
                                    precision)
            out.append(self._record(i, l, {
                "routed": routed.cpu(), "shared": shared.cpu(),
                "tokens_per_expert": torch.bincount(
                    top_e.reshape(-1), minlength=self.cfg.n_experts).cpu(),
                "top_e": top_e.cpu(), "rows_computed": top_e.numel()}))
        return out

    def check(self, kept: List[dict], last) -> List[Check]:
        tr = self.ctx.traffic
        tau = float(tr["tie_tolerance"])
        eps = self.cfg.norm_eps
        mismatch, gap = 0, 0.0
        for rec in kept:
            l = rec["layer"] - self.first
            p, x = self.params(l), self.x[l].reshape(-1, self.d_model)
            h = ref_moe.rms_norm(x, p["ln"], eps)
            _, _, own, margin = ref_moe.route(h, p["router"],
                                              p.get("router_bias"),
                                              self.routing)
            port = rec["top_e"].to(device=h.device, dtype=torch.int64)
            extra = (port[:, :, None] != own[:, None, :]).all(-1).sum(-1)
            mismatch += int(extra[margin > tau].sum())
            loads = torch.bincount(port.reshape(-1),
                                   minlength=self.cfg.n_experts).cpu()
            mismatch += int((loads - rec["tokens_per_expert"].long())
                            .abs().sum())
            del h, own, margin
            for e, L in ref_moe.expert_unit_kernels(x, p, self.routing, eps,
                                                    port):
                gap = max(gap, ref_moe.judge(L, rec["expert_picks"][e],
                                             int(loads[e]))["gap"])
            if "shared_picks" in rec:
                gap = max(gap, ref_moe.judge(
                    ref_moe.shared_unit_kernel(x, p, eps),
                    rec["shared_picks"], x.shape[0])["gap"])
        lim = tr["limits"]
        return [Check("route_mismatch", float(mismatch),
                      float(lim["route_mismatch"])),
                Check("map_gap", gap, float(lim["map_gap"])),
                Check("unjudged", float(not kept), 0.0)]

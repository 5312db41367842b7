"""Per-site MAC accounting (port of ``repro.launch.dryrun.per_site_macs``).

Pure arithmetic over a :class:`~repro_torch.configs.base.ModelConfig`: it
sets no environment and touches no device.  The reference's dryrun proper
(lowering a step, its HLO costs and collective bytes) is TPU-compile
tooling and waits with the multi-device port (ROADMAP A8).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import Family, ModelConfig


def per_site_macs(cfg: ModelConfig, seq_len: int = 1, batch: int = 1
                  ) -> Dict[str, Dict[str, float]]:
    """Analytic MAC counts per ``dense()`` call site for one forward pass.

    Returns ``{site: {"macs": total MACs over batch*seq_len tokens, "k":
    contraction dim, "bwd_macs": backward-pass MACs}}``, the per-site
    breakdown the search's cost model (:mod:`repro_torch.search.
    costmodel`) prices.  ``bwd_macs`` is twice the forward count (dL/dx
    and dL/dW, each a matmul of the forward's size).  Only projection sites
    count: the attention einsums and the SSD recurrence are not ``dense()``
    sites.  As the reference counts them: the router at one copy a layer,
    each expert site at ``top_k`` (the experts a token runs through); the
    SSM in projection at its unpadded width ``2 d_in + 2 N + H``
    (REPRO_SSM_PAD's dead columns carry no useful MACs), at one copy a
    mamba layer; a HYBRID model's shared attention and MLP sites at one
    copy a group."""
    if cfg.family not in (Family.DENSE, Family.MOE, Family.SSM, Family.HYBRID):
        raise NotImplementedError(
            f"per_site_macs for family {cfg.family.value!r} is not yet ported (ROADMAP A5)")
    d, f = cfg.d_model, cfg.d_ff
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    tokens = float(seq_len * batch)
    attn = {
        "attn_q": (d, h * dh),
        "attn_k": (d, kv * dh),
        "attn_v": (d, kv * dh),
        "attn_o": (h * dh, d),
    }
    mlp = {"mlp_gate": (d, f), "mlp_up": (d, f), "mlp_down": (f, d)}
    d_in, H, N = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_state
    ssm = {"ssm_in": (d, 2 * d_in + 2 * N + H), "ssm_out": (d_in, d)}
    out: Dict[str, Dict[str, float]] = {}

    def add(site: str, k: int, n: int, copies: float) -> None:
        if k <= 0 or n <= 0 or copies <= 0:
            return
        entry = out.setdefault(site, {"macs": 0.0, "bwd_macs": 0.0, "k": float(k)})
        macs = tokens * float(k) * float(n) * float(copies)
        entry["macs"] += macs
        entry["bwd_macs"] += 2.0 * macs

    if cfg.family in (Family.SSM, Family.HYBRID):
        for site, (k, n) in ssm.items():
            add(site, k, n, cfg.n_layers)  # groups and tail: n_layers mixers
        G = cfg.n_layers // cfg.shared_attn_every if cfg.family == Family.HYBRID else 0
        for site, (k, n) in {**attn, **mlp}.items():
            add(site, k, n, G)  # the shared block, applied once a group
        add("lm_head", d, cfg.vocab_size, 1)
        return out
    for site, (k, n) in attn.items():
        add(site, k, n, cfg.n_layers)
    if cfg.n_experts:
        add("moe_router", d, cfg.n_experts, cfg.n_layers)
        add("moe_gate", d, f, cfg.n_layers * cfg.top_k)
        add("moe_up", d, f, cfg.n_layers * cfg.top_k)
        add("moe_down", f, d, cfg.n_layers * cfg.top_k)
    else:
        for site, (k, n) in mlp.items():
            add(site, k, n, cfg.n_layers)
    add("lm_head", d, cfg.vocab_size, 1)
    return out

"""The dense family on the program's side: the port's ``ModelConfig`` for a
configuration file, and the port's flat parameters ([L, ...] layer leaves,
the embedding, the final norm, the head) filled from the benchmark's seeded
weights (the groups that ``reference/dense.py`` remakes)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from portbench.harness import weights as W
from portbench.reference import dense as ref


def port_config(conf: dict):
    """The configuration file as the port's ``ModelConfig``."""
    from repro_torch.configs import ModelConfig
    m = ref.dims(conf)
    return ModelConfig(
        arch=conf["name"], family="dense", num_layers=m["layers"], d_model=m["d"],
        num_heads=m["h"], num_kv_heads=m["kv"], d_ff=m["f"], vocab_size=m["v"],
        head_dim=m["hd"], qk_norm=bool(conf.get("qk_norm")),
        tie_embeddings=bool(conf.get("tie_word_embeddings")),
        rope_theta=float(conf["rope_theta"]), norm_eps=float(conf["rms_norm_eps"]),
        dtype=conf["torch_dtype"], source=conf["source"])


def port_params(conf: dict, seed: int, device) -> Dict[str, Any]:
    """The port's flat layout: one draw a layer, copied into its row of the
    stacked leaves; the vocabulary padded with zero rows / columns to the
    port's multiple of 128 (those logits are never compared)."""
    from repro_torch.models.layers import pad_vocab
    m = ref.dims(conf)
    spec = ref.layer_spec(conf)
    layers = {name: torch.empty((m["layers"],) + tuple(shape), dtype=torch.bfloat16,
                                device=device) for name, shape, _ in spec}
    for i in range(m["layers"]):
        for name, w in W.draw(spec, seed, ref.layer_tag(i), device).items():
            layers[name][i].copy_(w)
    g = ref.global_specs(conf)
    vpad = pad_vocab(m["v"]) - m["v"]
    embed = W.draw(g["embed"], seed, "embed", device)["embed"]
    head = W.draw(g["head"], seed, "head", device)["lm_head"]
    if vpad:
        embed = torch.cat([embed, embed.new_zeros((vpad, m["d"]))])
        head = torch.cat([head, head.new_zeros((m["d"], vpad))], dim=1)
    return {"layers": layers, "embed": embed,
            "final_norm": W.draw(g["final_norm"], seed, "final_norm", device)["final_norm"],
            "lm_head": head}

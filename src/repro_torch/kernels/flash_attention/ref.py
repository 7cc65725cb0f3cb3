"""Plain PyTorch versions of the flash-attention kernels.

``flash_attention_ref``: the function of
``repro/kernels/flash_attention/ref.py::attention_ref``, which the Pallas
kernel is held against: GQA attention with the whole score matrix
materialized, in float32, output in q's dtype.  Any S works, ragged or
not, and non-causal attention takes keys of a length of their own
(cross-attention over an encoder's memory).  With ``with_lse`` it also
returns each row's log-sum-exp of the scaled scores, in natural units,
which the backward reads.

``flash_attention_bwd_ref``: the gradient of that function, written the
way the backward kernels compute it (FlashAttention-2's algorithm): the
probabilities rebuilt from the saved log-sum-exp, no second softmax, and
the row term ``D = rowsum(P ∘ dP)`` (the row's dO · o) summed from the
probabilities, not read from the rounded output."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, with_lse: bool = False):
    """q ``[B, S, H, hd]``; k, v ``[B, Skv, Hkv, hd]`` (Skv = S when causal)
    → ``[B, S, H, hd]``; with ``with_lse`` also the float32 log-sum-exp
    ``[B, H, S]`` of each row's scaled scores (natural units)."""
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, S, Hkv, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, Skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    z = p.sum(-1, keepdim=True)
    p = p / z
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(B, S, H, hd).to(q.dtype)
    if not with_lse:
        return o
    return o, (m + torch.log(z)).reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, causal: bool = True):
    """The gradients ``(dq, dk, dv)`` of ``flash_attention_ref(q, k, v,
    causal)`` under the output gradient ``do`` ``[B, S, H, hd]``, from the
    forward's float32 log-sum-exp ``lse`` ``[B, H, S]`` (natural units), in
    float32 math and the inputs' dtypes: ``P = exp(s - lse)``,
    ``dV = Pᵀ dO``, ``dP = dO Vᵀ``, ``D = rowsum(P ∘ dP)``,
    ``dS = P ∘ (dP - D)``, ``dQ = dS K / sqrt(hd)``,
    ``dK = dSᵀ Q / sqrt(hd)``, the query heads that share a kv head summed
    into its dK and dV."""
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf, dof = (t.float().reshape(B, S, Hkv, G, hd) for t in (q, do))
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) / math.sqrt(hd)
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, S, 1))
    if causal:
        mask = torch.ones(S, Skv, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~mask, 0.0)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) / math.sqrt(hd)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) / math.sqrt(hd)
    return dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

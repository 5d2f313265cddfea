"""SE(3)-equivariant diffusion score network, in PyTorch.

Counterpart of diffbindfr_tpu/models/score_net.py. Same graphs, trunk and
heads: dense ligand-ligand and ligand-pocket pair blocks, a 16-neighbour
pocket-atom list, 6 tensor-product conv layers over the ladder
48x0e -> +12x1o -> +12x1e -> +48x0o, the centre-conv tr/rot head, the
ligand and side-chain pseudotorque heads and the sigma scaling. The forward
is written for a batch [B, ...] directly (the JAX package vmaps a
single-sample function).

`conv_mode` picks the convs' tensor product as the JAX field does: 'sep'
(the default, separable) or 'fc', the reference-exact fully connected TP
that a checkpoint imported from the reference needs
(utils/torch_import.py). 'fc' runs only on the plain path (the JAX package
has no kernel for it), its per-pair weights computed chunk by chunk of
pairs (nn/layers.fc_conv_mean), since a dense block of them would not fit
the card.

`use_kernels=True` is the counterpart of `use_pallas=True`: node features
stay component-major through the trunk, and the config's kernel fields pick
the kernels of each layer, with the JAX package's meaning and precedence
(score_net.py:410-418 there):
  * `pallas_layout='cmt'` (default; `pallas_bwd=True`): the three convs B1-B3
    (nn/trunk_convs.py, CUDA forward and backward kernels on the card), the
    finalize and residual adds in PyTorch; both flags below are ignored;
  * `'rowmajor'`: the same without a flag (the row-major kernels B7-B9 with
    `fin=None` compute B1-B3's contract); with `fused_epilogue`, B7-B9 with
    the finalize inside each kernel and only the residual adds in PyTorch;
    with `fused_layer` (which beats `fused_epilogue`), B10: the whole layer
    in one launch (nn/layer_conv.py).
`use_kernels=False` is the plain XLA-path port and reads none of those
fields. Every mode is differentiable; `init_params` draws a fresh tree with
the JAX package's initialisers.

`compute_dtype='bfloat16'` mirrors the JAX package's mixed precision
(score_net.py:313-322, 628-629, 651, 783 there): the f32 parameters, ligand
features and time embedding are cast to bf16 inside `apply` (the checkpoint
stays f32), geometry and masks stay f32, and the heads come back to f32
before the sigma scaling. The plain path runs its whole trunk in bf16; the
kernel path keeps the trunk f32 on bf16-rounded weights, as the Pallas path
does, and under 'cmt' its convs run the bf16 depthwise chain (B11, the
convs' `bf16_chain`) when `pallas_dw_dtype` asks for it: 'auto' (the
default) follows compute_dtype, as the JAX package's rule gives the cmT
kernels (score_net.py:120-130, 208-213 there). Training pins 'float32': the
backward of every conv is f32 (B4-B6), so a bf16 chain would pair a bf16
forward with an f32 backward.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..geometry import so3, torus
from ..nn import layer_conv as LC
from ..nn import layers as L
from ..nn import trunk_convs as TC
from ..nn.irreps import apply_full_tensor_product, compile_full_tensor_product

SH_IRREPS = "1x0e+1x1o+1x2e"


@dataclasses.dataclass(frozen=True)
class ScoreNetConfig:
    """The fields of the JAX ScoreNetConfig that the port reads, with the
    same defaults (the flagship model)."""

    ns: int = 48
    nv: int = 12
    num_conv_layers: int = 6
    sigma_embed_dim: int = 32
    distance_embed_dim: int = 32
    lig_node_dim: int = 27
    lig_edge_dim: int = 10
    atom_cat_dims: tuple = (37, 22, 4, 21, 2)
    lig_cutoff: float = 5.0
    atom_cutoff: float = 4.0
    cross_max_distance: float = 32.0
    center_max_distance: float = 32.0
    dynamic_max_cross: bool = True
    cross_cutoff: float = 32.0
    atom_knn: int = 16
    emb_scale: float = 1000.0
    scale_by_sigma: bool = True
    no_sc_torsion: bool = False
    # 'sep': separable depthwise TP + post-aggregation irreps Linear (the
    # kernels' mode); 'fc': the reference-exact per-edge uvw TP (checkpoints
    # imported from the reference), plain PyTorch only
    conv_mode: str = "sep"
    # recompute each trunk layer in the backward (torch.utils.checkpoint,
    # the JAX package's per-layer jax.checkpoint); the training CLI turns it
    # on unless --no-remat
    remat: bool = False
    # kernels of the trunk with use_kernels=True (the JAX fields of the same
    # names; see the module docstring): 'cmt' or 'rowmajor'
    pallas_layout: str = "cmt"
    fused_epilogue: bool = False
    fused_layer: bool = False

    # 'bfloat16': the trunk in bf16, heads and sigma scaling in f32
    compute_dtype: str = "float32"
    # the kernels' depthwise chain under 'cmt': 'bfloat16' (B11), 'float32'
    # (B1-B3) or 'auto' (bfloat16 iff compute_dtype is; JAX's default)
    pallas_dw_dtype: str = "auto"

    @property
    def dtype(self) -> torch.dtype:
        """The trunk's dtype (any value but 'bfloat16' is f32, as in JAX)."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def bf16_chain(self) -> bool:
        """Whether the kernel path's convs run the bf16 depthwise chain
        (B11): only in the cmt layout, by pallas_dw_dtype's JAX rule."""
        dwd = self.pallas_dw_dtype
        if dwd not in ("auto", "float32", "bfloat16"):
            raise ValueError(f"pallas_dw_dtype {dwd!r}: 'auto', 'float32' or 'bfloat16'")
        if dwd == "auto":
            dwd = "bfloat16" if self.compute_dtype == "bfloat16" else "float32"
        return self.pallas_layout == "cmt" and dwd == "bfloat16"

    @property
    def kernel_mode(self) -> str:
        """The trunk's kernel path under use_kernels=True: 'convs' (B1-B3,
        finalize in PyTorch), 'epilogue' (B7-B9 with fin) or 'layer' (B10)."""
        if self.pallas_layout not in ("cmt", "rowmajor"):
            raise ValueError(f"pallas_layout {self.pallas_layout!r}: 'cmt' or 'rowmajor'")
        if self.pallas_layout == "cmt":
            return "convs"
        return "layer" if self.fused_layer else "epilogue" if self.fused_epilogue else "convs"

    @property
    def irrep_seq(self) -> tuple:
        ns, nv = self.ns, self.nv
        return (
            f"{ns}x0e",
            f"{ns}x0e+{nv}x1o",
            f"{ns}x0e+{nv}x1o+{nv}x1e",
            f"{ns}x0e+{nv}x1o+{nv}x1e+{ns}x0o",
        )

    def layer_irreps(self, layer: int) -> tuple:
        seq = self.irrep_seq
        return seq[min(layer, len(seq) - 1)], seq[min(layer + 1, len(seq) - 1)]


class Sigmas(NamedTuple):
    """Per-sample noise levels [B] of the four manifolds."""

    tr: torch.Tensor
    rot: torch.Tensor
    tor: torch.Tensor
    sc_tor: torch.Tensor


class SigmaScales(NamedTuple):
    """Per-sample output scales [B] of the rot, tor and sc_tor heads."""

    rot: torch.Tensor  # IGSO(3) score norm
    tor: torch.Tensor  # sqrt of the torus score norm
    sc_tor: torch.Tensor


def sigma_scales(sigmas: Sigmas) -> SigmaScales:
    """Score-norm scales at `sigmas`: lookups in the device tables."""
    return SigmaScales(rot=so3.score_norm(sigmas.rot),
                       tor=torch.sqrt(torus.score_norm(sigmas.tor)),
                       sc_tor=torch.sqrt(torus.score_norm(sigmas.sc_tor)))


class ScoreOutput(NamedTuple):
    tr: torch.Tensor  # [B, 3]
    rot: torch.Tensor  # [B, 3]
    tor: torch.Tensor  # [B, T]
    sc_tor: torch.Tensor  # [B, R, 4]


@functools.lru_cache(maxsize=8)
def _specs(cfg: ScoreNetConfig):
    """Static TP path tables of every conv in the network."""
    mode = cfg.conv_mode
    convs = tuple(L.make_conv_spec(cfg.layer_irreps(l)[0], SH_IRREPS, cfg.layer_irreps(l)[1], mode)
                  for l in range(cfg.num_conv_layers))
    final_in = cfg.layer_irreps(cfg.num_conv_layers - 1)[1]
    final = L.make_conv_spec(final_in, SH_IRREPS, "2x1o+2x1e", mode)
    # FullTP(sh, bond 2e) truncated to l <= 1 is exact here: higher-l outputs
    # cannot couple the l <= 1 ladder to the 0o+0e conv output
    tor_sh = compile_full_tensor_product(SH_IRREPS, "1x2e", lmax_out=1)
    tor_conv = L.make_conv_spec(final_in, str(tor_sh.out), f"{cfg.ns}x0o+{cfg.ns}x0e", mode)
    return convs, final, tor_sh, tor_conv


@functools.lru_cache(maxsize=8)
def _kernel_consts(cfg: ScoreNetConfig):
    """Per layer: (pair, cross, knn) ConvConsts of the trunk kernels."""
    convs = _specs(cfg)[0]
    kw = dict(ns=cfg.ns, sed=cfg.sigma_embed_dim, gs_n=cfg.distance_embed_dim)
    return tuple(
        (TC.ConvConsts(s.dw, gs_stop=cfg.lig_cutoff, **kw),
         TC.ConvConsts(s.dw, gs_stop=cfg.cross_max_distance, **kw),
         TC.ConvConsts(s.dw, gs_stop=cfg.atom_cutoff, **kw))
        for s in convs
    )


@functools.lru_cache(maxsize=8)
def _layer_consts(cfg: ScoreNetConfig):
    """Per layer: the LayerConsts of B10 (its FinConsts serve B7-B9)."""
    return tuple(LC.LayerConsts(spec, *consts)
                 for spec, consts in zip(_specs(cfg)[0], _kernel_consts(cfg)))


def _gs(cfg, d, stop):
    return L.gaussian_smearing(d, 0.0, stop, cfg.distance_embed_dim)


def _bexp(x, *shape):
    """Broadcast per-sample vectors [B, C] to [B, *shape, C]."""
    return x.reshape(x.shape[0], *([1] * len(shape)), x.shape[-1]).expand(
        x.shape[0], *shape, x.shape[-1])


def _gather_rows(x, idx):
    """x [B, N, C], idx [B, ...] -> [B, ..., C]."""
    b = torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


def apply(params, cfg: ScoreNetConfig, s, t, sigmas: Sigmas, use_kernels: bool = True,
          scales: SigmaScales | None = None):
    """Batched forward. s: DockingSample of tensors [B, ...]; t [B]; `scales`
    = sigma_scales(sigmas), looked up here when not given. conv_mode 'fc'
    runs only with use_kernels=False."""
    if use_kernels and cfg.conv_mode == "fc":
        raise ValueError("conv_mode 'fc' has no kernel path: the JAX package has no kernel for "
                         "'fc' (its Pallas convs are 'sep' only); call apply with "
                         "use_kernels=False")
    ns = cfg.ns
    convs, final_spec, tor_sh_spec, tor_conv_spec = _specs(cfg)
    bsz, nl, na = s.lig_pos.shape[0], s.lig_pos.shape[1], s.atm_pos.shape[1]
    dev = s.lig_pos.device
    bidx = torch.arange(bsz, device=dev)

    # mixed precision: geometry and masks stay f32, the trunk runs in cd
    cd = cfg.dtype
    if cd != torch.float32:
        params = _cast_f32_leaves(params, cd)
        s = s._replace(lig_feat=s.lig_feat.to(cd), lig_e_feat=s.lig_e_feat.to(cd))
    temb = L.sinusoidal_time_emb(t, cfg.sigma_embed_dim, cfg.emb_scale).to(cd)  # [B, sed]

    # ---------------- node embeddings
    lig_x = L.mlp_apply(params["lig_node_emb"],
                        torch.cat([s.lig_feat, _bexp(temb, nl)], dim=-1))
    atom_x = L.atom_encoder_apply(params["atom_node_emb"], s.atm_feat, _bexp(temb, na))

    # ---------------- ligand graph: dense masked pair block
    bond_feat = torch.zeros(bsz, nl, nl, cfg.lig_edge_dim, dtype=cd, device=dev)
    bond_feat.index_put_((bidx[:, None], s.lig_e_src, s.lig_e_dst),
                         s.lig_e_feat * s.lig_e_mask[..., None].to(cd), accumulate=True)
    bond_mask = torch.zeros(bsz, nl, nl, device=dev)
    bond_mask.index_put_((bidx[:, None], s.lig_e_src, s.lig_e_dst), s.lig_e_mask,
                         accumulate=True)
    lig_vec = s.lig_pos[:, None, :, :] - s.lig_pos[:, :, None, :]  # i -> j
    lig_len = torch.linalg.norm(lig_vec + 1e-9, dim=-1)
    both_l = (s.lig_mask[:, :, None] * s.lig_mask[:, None, :]) > 0
    eye = torch.eye(nl, dtype=torch.bool, device=dev)
    lig_pair_mask = ((((lig_len <= cfg.lig_cutoff) & ~eye) | (bond_mask > 0)) & both_l).float()

    # ---------------- atom graph: radius-4A fixed-degree neighbour list
    atm_idx, atm_valid = L.knn_edges(s.atm_pos, s.atm_pos, s.atm_mask, s.atm_mask,
                                     k=min(cfg.atom_knn, na), cutoff=cfg.atom_cutoff,
                                     exclude_self=True)
    ka = atm_idx.shape[-1]
    atm_vmask = atm_valid.float()

    # ---------------- cross graph: dense [NL, NA]; CA/CB atoms always on
    cabflag = torch.zeros(bsz, na, device=dev)
    cabflag.index_put_((bidx[:, None], s.cab_idx), s.cab_mask, accumulate=True)
    cabflag = cabflag > 0
    if cfg.dynamic_max_cross:
        cross_cutoff = sigmas.tr * 0.2 + 5.0
    else:
        cross_cutoff = torch.full((bsz,), cfg.cross_cutoff, device=dev)
    cross_vec = s.atm_pos[:, None, :, :] - s.lig_pos[:, :, None, :]  # lig -> atom
    cross_len = torch.linalg.norm(cross_vec + 1e-9, dim=-1)
    both_c = (s.lig_mask[:, :, None] * s.atm_mask[:, None, :]) > 0
    cross_mask = ((cabflag[:, None, :] | (cross_len <= cross_cutoff[:, None, None]))
                  & both_c).float()

    if use_kernels:
        mode = cfg.kernel_mode
        lconsts = _layer_consts(cfg)
        if mode == "layer" and ka < cfg.atom_knn:
            # as the JAX package pads for its k-specialised layer kernel
            atm_idx = torch.nn.functional.pad(atm_idx, (0, cfg.atom_knn - ka))
            atm_vmask = torch.nn.functional.pad(atm_vmask, (0, cfg.atom_knn - ka))
        cnt_lig = torch.clamp(lig_pair_mask.sum(2), min=1.0)
        cnt_al = torch.clamp(cross_mask.sum(2), min=1.0)
        cnt_la = torch.clamp(cross_mask.sum(1), min=1.0)
        cnt_atm = torch.clamp(atm_vmask.sum(2), min=1.0)
        cab_f = cabflag.float()
        zero_l = torch.zeros_like(s.lig_mask)
        # the trunk stays f32 in kernel mode (JAX score_net.py:437-444)
        lig_cm = TC.cm_from_irreps(convs[0].dw.in1, lig_x.float())
        atom_cm = TC.cm_from_irreps(convs[0].dw.in1, atom_x.float())
        graph = dict(s=s, zero_l=zero_l, temb=temb, bond_feat=bond_feat, bond_mask=bond_mask,
                     cab_f=cab_f, cross_cutoff=cross_cutoff, atm_idx=atm_idx,
                     atm_vmask=atm_vmask, cnt_lig=cnt_lig, cnt_al=cnt_al, cnt_la=cnt_la,
                     cnt_atm=cnt_atm)
        layer_fn = {"convs": _kernel_layer, "epilogue": _epilogue_layer,
                    "layer": _fused_layer}[mode]
        for l in range(cfg.num_conv_layers):
            lp = {k: params[f"{k}_convs"][l] for k in ("lig", "al", "la", "atom")}

            def kernel_layer(lig_cm, atom_cm, lc=lconsts[l], lp=lp):
                return layer_fn(params, cfg, lc, lp, graph, lig_cm, atom_cm)

            lig_cm, atom_cm = _remat(cfg, kernel_layer, lig_cm, atom_cm)
        final_ladder = convs[-1].out
        lig_x = TC.cm_to_irreps(final_ladder, lig_cm).to(cd)
        atom_x = TC.cm_to_irreps(final_ladder, atom_cm).to(cd)
    else:
        lig_e_attr = L.mlp_apply(params["lig_edge_emb"], torch.cat(
            [bond_feat, _bexp(temb, nl, nl), _gs(cfg, lig_len, cfg.lig_cutoff).to(cd)], dim=-1))
        lig_sh = L.sh_l2(lig_vec).to(cd)
        atm_vec = _gather_rows(s.atm_pos, atm_idx) - s.atm_pos[:, :, None, :]
        atm_len = torch.linalg.norm(atm_vec + 1e-9, dim=-1)
        atm_e_attr = L.mlp_apply(params["atom_edge_emb"], torch.cat(
            [_bexp(temb, na, ka), _gs(cfg, atm_len, cfg.atom_cutoff).to(cd)], dim=-1))
        atm_sh = L.sh_l2(atm_vec).to(cd)
        la_attr = L.mlp_apply(params["la_edge_emb"], torch.cat(
            [_bexp(temb, nl, na), _gs(cfg, cross_len, cfg.cross_max_distance).to(cd)], dim=-1))
        cross_sh = L.sh_l2(cross_vec).to(cd)
        for l in range(cfg.num_conv_layers):
            spec = convs[l]
            lp = {k: params[f"{k}_convs"][l] for k in ("lig", "al", "la", "atom")}

            def plain_layer(lig_x, atom_x, spec=spec, lp=lp):
                return _plain_layer(spec, lp, ns, lig_x, atom_x, lig_e_attr, lig_sh,
                                lig_pair_mask, la_attr, cross_sh, cross_mask, atm_e_attr,
                                atm_sh, atm_idx, atm_vmask)

            lig_x, atom_x = _remat(cfg, plain_layer, lig_x, atom_x)

    # ---------------- tr / rot head: centre conv
    wsum = torch.clamp(s.lig_mask.sum(1), min=1.0)
    center = (s.lig_pos * s.lig_mask[..., None]).sum(1) / wsum[:, None]
    c_vec = s.lig_pos - center[:, None, :]
    c_len = torch.linalg.norm(c_vec + 1e-12, dim=-1)
    c_attr = L.mlp_apply(params["center_edge_emb"], torch.cat(
        [_bexp(temb, nl), _gs(cfg, c_len, cfg.center_max_distance).to(cd)], dim=-1))
    c_sh = L.sh_l2(c_vec).to(cd)
    agg = L.conv_mean(params["final_conv"], final_spec, lig_x, c_sh,
                      [c_attr, lig_x[..., :ns]], s.lig_mask, dim=1)
    gp = L.tp_conv_finalize(params["final_conv"], final_spec, agg).float()  # [B, 12]

    tr_pred = gp[:, 0:3] + gp[:, 6:9]
    rot_pred = gp[:, 3:6] + gp[:, 9:12]
    if "readout_rot" in params:
        # fixed basis rotation of checkpoints imported from e3nn
        rot_const = params["readout_rot"].detach().float()
        tr_pred = tr_pred @ rot_const.T
        rot_pred = rot_pred @ rot_const.T
    temb32 = temb.float()
    tr_norm = torch.linalg.norm(tr_pred, dim=-1, keepdim=True) + 1e-12
    tr_pred = tr_pred / tr_norm * L.mlp_apply(params["tr_final"],
                                              torch.cat([tr_norm, temb32], -1))
    rot_norm = torch.linalg.norm(rot_pred, dim=-1, keepdim=True) + 1e-12
    rot_pred = rot_pred / rot_norm * L.mlp_apply(params["rot_final"],
                                                 torch.cat([rot_norm, temb32], -1))

    # ---------------- ligand pseudotorque head
    tor_pred = _pseudotorque(
        params["tor_edge_emb"], params["tor_bond_conv"], params["tor_final"],
        tor_sh_spec, tor_conv_spec, node_x=lig_x, node_pos=s.lig_pos,
        node_mask=s.lig_mask, bond_src=s.tor_src, bond_dst=s.tor_dst,
        bond_mask=s.tor_mask, k=min(32, nl), cutoff=cfg.lig_cutoff, cfg=cfg, cd=cd)

    # ---------------- side-chain pseudotorque head
    if not cfg.no_sc_torsion:
        nres = s.sc_src.shape[1]
        sc_pred = _pseudotorque(
            params["sc_edge_emb"], params["sc_tor_bond_conv"], params["sc_tor_final"],
            tor_sh_spec, tor_conv_spec, node_x=atom_x, node_pos=s.atm_pos,
            node_mask=s.atm_mask, bond_src=s.sc_src.reshape(bsz, -1),
            bond_dst=s.sc_dst.reshape(bsz, -1), bond_mask=s.chi_mask.reshape(bsz, -1),
            k=24, cutoff=cfg.atom_cutoff, cfg=cfg, cd=cd).reshape(bsz, nres, 4)
    else:
        sc_pred = torch.zeros_like(s.chi_mask)

    # ---------------- scale by sigma
    if cfg.scale_by_sigma:
        if scales is None:
            scales = sigma_scales(sigmas)
        tr_pred = tr_pred / sigmas.tr[:, None]
        rot_pred = rot_pred * scales.rot[:, None]
        tor_pred = tor_pred * scales.tor[:, None]
        sc_pred = sc_pred * scales.sc_tor[:, None, None]

    return ScoreOutput(tr=tr_pred, rot=rot_pred, tor=tor_pred * s.tor_mask,
                       sc_tor=sc_pred * s.chi_mask)


def _cast_f32_leaves(tree, dtype):
    """The parameter tree with its f32 leaves cast to `dtype` (JAX castp)."""
    if isinstance(tree, dict):
        return {k: _cast_f32_leaves(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_f32_leaves(v, dtype) for v in tree)
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def _remat(cfg: ScoreNetConfig, layer, lig, atom):
    """layer(lig, atom), recomputed in the backward when cfg.remat is set."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(layer, lig, atom, use_reentrant=False)
    return layer(lig, atom)


def _kernel_layer(params, cfg, lc, lp, g, lig_cm, atom_cm):
    """One trunk layer through B1-B3 (B11 with the bf16 chain under 'cmt'),
    component-major layout; the finalize and residual adds in PyTorch."""
    s, temb = g["s"], g["temb"]
    spec, c_lig, c_cross, c_knn = lc.spec, lc.lig, lc.cross, lc.atom
    out_dim = spec.out.dim
    bf16 = cfg.bf16_chain
    lig_sum = TC.pair_conv(
        c_lig, s.lig_pos, s.lig_pos, lig_cm, lig_cm, s.lig_mask, s.lig_mask,
        g["zero_l"], g["zero_l"], temb, cfg.lig_cutoff,
        TC.pair_params(params["lig_edge_emb"], lp["lig"]["fc"]), g["bond_feat"], g["bond_mask"],
        bf16_chain=bf16)
    al_sum, la_sum = TC.cross_conv(
        c_cross, s.lig_pos, s.atm_pos, lig_cm, atom_cm, s.lig_mask, s.atm_mask,
        g["cab_f"], temb, g["cross_cutoff"], params["la_edge_emb"], lp["al"]["fc"],
        lp["la"]["fc"], bf16_chain=bf16)
    atm_sum = TC.knn_conv(
        c_knn, s.atm_pos, atom_cm, s.atm_mask, g["atm_idx"], g["atm_vmask"], temb,
        {"emb": params["atom_edge_emb"], "fc": lp["atom"]["fc"]}, bf16_chain=bf16)
    lig_update = L.tp_conv_finalize_cm(lp["lig"], spec, lig_sum / g["cnt_lig"][..., None])
    al_update = L.tp_conv_finalize_cm(lp["al"], spec, al_sum / g["cnt_al"][..., None])
    la_update = L.tp_conv_finalize_cm(lp["la"], spec, la_sum / g["cnt_la"][..., None])
    atom_update = L.tp_conv_finalize_cm(lp["atom"], spec, atm_sum / g["cnt_atm"][..., None])
    lig2 = L.pad_to_dim(lig_cm, out_dim) + lig_update + al_update
    atom2 = L.pad_to_dim(atom_cm, out_dim) + atom_update + la_update
    return lig2, atom2


def _fin(lp_conv):
    return {"mix": lp_conv["mix"], "ln": lp_conv["ln"]}


def _epilogue_layer(params, cfg, lc, lp, g, lig_cm, atom_cm):
    """One trunk layer through B7-B9 with the finalize in the kernels; only
    the residual adds in PyTorch (JAX score_net.py:485-519)."""
    s, temb, fin = g["s"], g["temb"], lc.fin
    lig_update = TC.pair_conv_fin(
        lc.lig, fin, s.lig_pos, s.lig_pos, lig_cm, lig_cm, s.lig_mask, s.lig_mask,
        g["zero_l"], g["zero_l"], temb, cfg.lig_cutoff,
        {**TC.pair_params(params["lig_edge_emb"], lp["lig"]["fc"]), **_fin(lp["lig"])},
        g["bond_feat"], g["bond_mask"], g["cnt_lig"])
    al_update, la_update = TC.cross_conv_fin(
        lc.cross, fin, s.lig_pos, s.atm_pos, lig_cm, atom_cm, s.lig_mask, s.atm_mask,
        g["cab_f"], temb, g["cross_cutoff"], params["la_edge_emb"], lp["al"]["fc"],
        lp["la"]["fc"], _fin(lp["al"]), _fin(lp["la"]), g["cnt_al"], g["cnt_la"])
    atom_update = TC.knn_conv_fin(
        lc.atom, fin, s.atm_pos, atom_cm, s.atm_mask, g["atm_idx"], g["atm_vmask"], temb,
        {"emb": params["atom_edge_emb"], "fc": lp["atom"]["fc"], **_fin(lp["atom"])})
    lig2 = L.pad_to_dim(lig_cm, fin.out_dim) + lig_update + al_update
    atom2 = L.pad_to_dim(atom_cm, fin.out_dim) + atom_update + la_update
    return lig2, atom2


def _fused_layer(params, cfg, lc, lp, g, lig_cm, atom_cm):
    """One trunk layer in one B10 launch (JAX score_net.py:457-479)."""
    s = g["s"]
    lparams = {"emb_lig": params["lig_edge_emb"], "emb_cross": params["la_edge_emb"],
               "emb_atom": params["atom_edge_emb"]}
    for t in ("lig", "al", "la", "atom"):
        lparams.update({f"fc_{t}": lp[t]["fc"], f"mix_{t}": lp[t]["mix"],
                        f"ln_{t}": lp[t]["ln"]})
    return LC.layer_conv(lc, s.lig_pos, s.atm_pos, lig_cm, atom_cm, s.lig_mask, s.atm_mask,
                         g["cab_f"], g["temb"], g["cross_cutoff"], g["bond_feat"],
                         g["bond_mask"], g["atm_idx"], g["atm_vmask"], g["cnt_lig"],
                         g["cnt_al"], g["cnt_la"], g["cnt_atm"], lparams)


def _plain_layer(spec, lp, ns, lig_x, atom_x, lig_e_attr, lig_sh, lig_pair_mask,
                 la_attr, cross_sh, cross_mask, atm_e_attr, atm_sh, atm_idx, atm_vmask):
    """One trunk layer on the plain (XLA-path) graph tensors, irreps layout;
    each conv's mean through layers.conv_mean (chunked under 'fc')."""
    out_dim = spec.out.dim

    def conv(name, src, sh, parts, mask, dim=2):
        return L.tp_conv_finalize(lp[name], spec,
                                  L.conv_mean(lp[name], spec, src, sh, parts, mask, dim))

    # the broadcast operands keep their axes of size 1 (conv_mean expands
    # them under 'sep'; under 'fc' the chunked backward sums their
    # gradients over those axes without a block-sized buffer)
    # ligand <- ligand
    lig_update = conv("lig", lig_x[:, None], lig_sh,
                      [lig_e_attr, lig_x[:, :, None, :ns], lig_x[:, None, :, :ns]], lig_pair_mask)
    # ligand <- atoms (al), mean over atoms
    al_update = conv("al", atom_x[:, None], cross_sh,
                     [la_attr, lig_x[:, :, None, :ns], atom_x[:, None, :, :ns]], cross_mask)
    # atoms <- atoms, gather-form knn
    nbr = _gather_rows(atom_x, atm_idx)
    atom_update = conv("atom", nbr, atm_sh, [atm_e_attr, atom_x[:, :, None, :ns], nbr[..., :ns]],
                       atm_vmask)
    # atoms <- ligand (la), mean over the ligand
    la_update = conv("la", lig_x[:, :, None], cross_sh,
                     [la_attr, atom_x[:, None, :, :ns], lig_x[:, :, None, :ns]], cross_mask, dim=1)
    lig2 = L.pad_to_dim(lig_x, out_dim) + lig_update + al_update
    atom2 = L.pad_to_dim(atom_x, out_dim) + atom_update + la_update
    return lig2, atom2


def _pseudotorque(emb_p, conv_p, final_p, tor_sh_spec, tor_conv_spec, *, node_x,
                  node_pos, node_mask, bond_src, bond_dst, bond_mask, k, cutoff, cfg, cd):
    """Bond midpoints gather nearby nodes; edge sh = FullTP(sh(edge),
    sh_2e(bond)); one scalar score per bond, f32. Batched [B, NB]."""
    ns = cfg.ns
    bsz, nb = bond_src.shape
    bond_vec = _gather_rows(node_pos, bond_dst) - _gather_rows(node_pos, bond_src)
    bond_sh2 = L.sh_l2(bond_vec)[..., 4:9].to(cd)
    bond_attr = _gather_rows(node_x, bond_src) + _gather_rows(node_x, bond_dst)
    mid = 0.5 * (_gather_rows(node_pos, bond_src) + _gather_rows(node_pos, bond_dst))
    idx, valid = L.knn_edges(mid, node_pos, bond_mask, node_mask, k=k, cutoff=cutoff)
    vec = _gather_rows(node_pos, idx) - mid[:, :, None, :]
    length = torch.linalg.norm(vec + 1e-12, dim=-1)
    e_attr = L.mlp_apply(emb_p, _gs(cfg, length, cutoff).to(cd))
    nbr = _gather_rows(node_x, idx)
    parts = [e_attr, nbr[..., :ns], bond_attr[:, :, None, :ns]]
    tor_sh = apply_full_tensor_product(tor_sh_spec, L.sh_l2(vec).to(cd),
                                       bond_sh2[:, :, None, :].expand(bsz, nb, k, 5))
    agg = L.conv_mean(conv_p, tor_conv_spec, nbr, tor_sh, parts, valid.float(), dim=2)
    agg = L.tp_conv_finalize(conv_p, tor_conv_spec, agg)
    return L.mlp_apply(final_p, agg, act=torch.tanh)[..., 0].float()


def sigmas_from_t(t, schedule) -> Sigmas:
    """Geometric interpolation sigma_min^(1-t) sigma_max^t."""
    def geo(lo, hi):
        return lo ** (1.0 - t) * hi**t

    return Sigmas(
        tr=geo(schedule["tr_sigma_min"], schedule["tr_sigma_max"]),
        rot=geo(schedule["rot_sigma_min"], schedule["rot_sigma_max"]),
        tor=geo(schedule["tor_sigma_min"], schedule["tor_sigma_max"]),
        sc_tor=geo(schedule["sc_tor_sigma_min"], schedule["sc_tor_sigma_max"]),
    )


# ---------------------------------------------------------------------------
# initialisation (models/score_net.py:init_params and nn/layers.py of the JAX
# package: the same tree, keys, shapes and distributions; the draws differ)
# ---------------------------------------------------------------------------


def _uniform(gen, shape, a):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * a


def _linear_init(gen, din, dout, bias=True):
    p = {"w": _uniform(gen, (din, dout), math.sqrt(6.0 / (din + dout)))}  # xavier
    if bias:
        p["b"] = torch.zeros(dout)
    return p


def _mlp_init(gen, din, dout, hidden=None, bias=True):
    hidden = dout if hidden is None else hidden
    return {"l1": _linear_init(gen, din, hidden, bias), "l2": _linear_init(gen, hidden, dout, bias)}


def _layer_norm_init(irreps):
    shift = np.concatenate([np.ones(mul) if (ir.l == 0 and ir.p == 1) else np.zeros(mul)
                            for mul, ir in irreps.items])
    return {"mean_shift": torch.tensor(shift, dtype=torch.float32),
            "weight": torch.ones(sum(mul for mul, _ in irreps.items)),
            "bias": torch.zeros(irreps.num_scalars)}


def _tp_conv_init(gen, spec: L.ConvSpec, n_edge: int):
    if spec.mode == "fc":  # no mix: the per-edge uvw weights mix the channels
        return {"fc": _mlp_init(gen, n_edge, spec.fc.weight_numel, n_edge),
                "ln": _layer_norm_init(spec.out)}
    mix = [torch.randn(n_in * mul3, generator=gen) / math.sqrt(max(n_in, 1))
           for _, _, _, n_in, mul3 in spec.lin.blocks]
    return {"fc": _mlp_init(gen, n_edge, spec.dw.weight_numel, n_edge),
            "mix": torch.cat(mix) if mix else torch.zeros(0),
            "ln": _layer_norm_init(spec.out)}


def _atom_encoder_init(gen, emb_dim, cat_dims, scalar_dim):
    embs = [{"emb": _uniform(gen, (n, emb_dim), math.sqrt(6.0 / (n + emb_dim)))}
            for n in cat_dims]
    lin = emb_dim + scalar_dim
    return {"embs": embs,
            "scalar_lin": {"w": _uniform(gen, (lin, emb_dim), math.sqrt(6.0 / lin))}}  # kaiming


def init_params(generator: torch.Generator, cfg: ScoreNetConfig, device="cpu"):
    """A fresh parameter tree (float32 on `device`) drawn from the CPU
    `generator`."""
    ns, sed, ded = cfg.ns, cfg.sigma_embed_dim, cfg.distance_embed_dim
    convs, final, _, tor_conv = _specs(cfg)
    g = generator
    p = {
        "lig_node_emb": _mlp_init(g, cfg.lig_node_dim + sed, ns),
        "lig_edge_emb": _mlp_init(g, cfg.lig_edge_dim + sed + ded, ns),
        "atom_node_emb": _atom_encoder_init(g, ns, cfg.atom_cat_dims, sed),
        "atom_edge_emb": _mlp_init(g, sed + ded, ns),
        "la_edge_emb": _mlp_init(g, sed + ded, ns),
        "lig_convs": [], "atom_convs": [], "al_convs": [], "la_convs": [],
        "center_edge_emb": _mlp_init(g, sed + ded, ns),
        "final_conv": _tp_conv_init(g, final, 2 * ns),
        "tr_final": _mlp_init(g, 1 + sed, 1, hidden=ns),
        "rot_final": _mlp_init(g, 1 + sed, 1, hidden=ns),
        "tor_edge_emb": _mlp_init(g, ded, ns),
        "tor_bond_conv": _tp_conv_init(g, tor_conv, 3 * ns),
        "tor_final": _mlp_init(g, 2 * ns, 1, hidden=ns, bias=False),
    }
    for spec in convs:
        for k in ("lig", "atom", "al", "la"):
            p[f"{k}_convs"].append(_tp_conv_init(g, spec, 3 * ns))
    if not cfg.no_sc_torsion:
        p["sc_edge_emb"] = _mlp_init(g, ded, ns)
        p["sc_tor_bond_conv"] = _tp_conv_init(g, tor_conv, 3 * ns)
        p["sc_tor_final"] = _mlp_init(g, 2 * ns, 1, hidden=ns, bias=False)
    return _tree_to(p, device)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)

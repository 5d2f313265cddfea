"""B10: one whole trunk layer in one kernel launch, and its plain version.

Counterpart of diffbindfr_tpu/nn/pallas_layer.py (`make_layer_conv`, the
pallas_call at :552): the ligand<-ligand pair conv, the dual ligand<->atom
cross conv and the atom knn conv of one layer, the four finalizes (count
divide -> irreps-Linear mix -> LayerNorm) and the residual ladder adds, node
features in, next-layer node features out, component-major f32:

    lig_next = pad(lig_cm) + fin_lig(pair sums) + fin_al(al sums)
    atm_next = pad(atm_cm) + fin_atom(knn sums) + fin_la(la sums)

`layer_conv` launches csrc/layer_conv.cu on CUDA tensors (one launch per
call, counted in trunk_convs.launches["layer_conv"]) or raises; on CPU
tensors it runs `layer_conv_plain`, the port of the twin at
pallas_layer.py:581-686, composed of the three convs' plain versions and
the plain finalize. Its backward recomputes through the plain version with
autograd (pallas_layer.py:688-697 differentiates the twin the same way).

The kernel's blocks own target rows (`row_groups`: g_l ligand rows or g_a
atoms each) and walk their valid pairs in 64-pair tiles
(csrc/conv_fwd_wide.cuh). `layer_tile_plan` is the plain model of that plan
(which block owns which targets, how each conv's candidates fall into
tiles) and `layer_conv_tiled_plain` computes the layer by walking it, for
the CPU tests to hold against `layer_conv_plain` and the JAX twin.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import trunk_convs as TC
from .layers import ConvSpec, pad_to_dim

# Order of the kernel's pointer, int and float arguments: the enums LayerPtr,
# LayerInt and LayerFloat of csrc/layer_conv.cu, name for name.
PTRS = (
    "lig_pos", "atm_pos", "lig_x", "atm_x", "lig_mask", "atm_mask", "cab", "lig_cut",
    "cross_cut", "bond_feat", "bond_mask", "knn_idx", "knn_valid", "ck", "out_meta",
    "gs_lig", "gs_cross", "gs_atom", "mix_meta", "ln_slots", "out_lig", "out_atm",
    *[f"{e}_{w}" for e in ("emb_lig", "emb_cross", "emb_atom")
      for w in ("w_in", "beff", "w2", "b2")],
    *[f"{t}_{w}" for t in ("lig", "al", "la", "atom")
      for w in ("w1", "b1", "w2", "b2", "cnt", "mix", "ln_w", "ln_ms", "ln_b")],
    "cycles",
)
INTS = ("batch", "nl", "na", "k", "din", "dout", "nb", "ns", "he_lig", "he_cross", "he_atom",
        "hf", "nw", "kdim", "gs_n", "out_dim", "n_slots", "mix_numel", "lig_rows", "atom_rows")
FLOATS = ("gs_coeff_lig", "gs_coeff_cross", "gs_coeff_atom")


@dataclasses.dataclass(frozen=True)
class LayerConsts:
    """Static tables of one trunk layer: its ConvSpec and the three convs'
    ConvConsts (their Gaussian stops: ligand, cross and atom cutoffs); the
    ligand pair cutoff is the ligand conv's stop, as in the JAX kernel."""

    spec: ConvSpec
    lig: TC.ConvConsts
    cross: TC.ConvConsts
    atom: TC.ConvConsts

    @functools.cached_property
    def fin(self) -> TC.FinConsts:
        return TC.FinConsts(self.spec)


def _fin_params(params, tag):
    return {"mix": params[f"mix_{tag}"], "ln": params[f"ln_{tag}"]}


def layer_conv_plain(lc: LayerConsts, lig_pos, atm_pos, lig_cm, atm_cm, lig_mask, atm_mask, cab,
                     temb, cross_cutoff, bond_feat, bond_mask, atm_idx, atm_valid, cnt_lig,
                     cnt_al, cnt_la, cnt_atm, params):
    """Plain B10 (the twin of make_layer_conv), batched over B.

    params: {'emb_lig', 'emb_cross', 'emb_atom': edge MLPs; 'fc_lig',
    'fc_al', 'fc_la', 'fc_atom': TP-weight MLPs; 'mix_*': irreps-Linear
    weights; 'ln_*': LayerNorm dicts}."""
    fin = lc.fin
    zero = torch.zeros_like(lig_mask)
    pair_p = TC.pair_params(params["emb_lig"], params["fc_lig"])
    lig = TC.pair_conv_plain(lc.lig, lig_pos, lig_pos, lig_cm, lig_cm, lig_mask, lig_mask, zero,
                             zero, temb, lc.lig.gs_stop, pair_p, bond_feat, bond_mask)
    al, la = TC.cross_conv_plain(lc.cross, lig_pos, atm_pos, lig_cm, atm_cm, lig_mask, atm_mask,
                                 cab, temb, cross_cutoff, params["emb_cross"], params["fc_al"],
                                 params["fc_la"])
    atm = TC.knn_conv_plain(lc.atom, atm_pos, atm_cm, atm_mask, atm_idx, atm_valid, temb,
                            {"emb": params["emb_atom"], "fc": params["fc_atom"]})

    def f(tag, agg, cnt):
        return TC.finalize_plain(fin, _fin_params(params, tag), agg, cnt)

    lig_next = pad_to_dim(lig_cm, fin.out_dim) + f("lig", lig, cnt_lig) + f("al", al, cnt_al)
    atm_next = pad_to_dim(atm_cm, fin.out_dim) + f("atom", atm, cnt_atm) + f("la", la, cnt_la)
    return lig_next, atm_next


# ---- the kernel's block plan (csrc/conv_fwd_wide.cuh, layer_conv.cu) -----

WIDE_TILE = TC.WIDE_TILE  # pairs per tile
SMEM_WORDS = TC.SMEM_WORDS  # the H100's shared memory per block, 4-byte words
LIG_ROWS, ATOM_ROWS = 4, 16  # rows per block, as many as fit (row_groups)


def plan_words(ints: dict, g_l: int, g_a: int) -> int:
    """Shared memory of a B10 block in 4-byte words (layer_plan: the four
    convs' plans, region by region the largest), from the kernel's INTS."""
    n = ints
    common = (n["ns"], None, n["hf"], n["nw"], n["kdim"], n["din"], n["dout"], n["out_dim"],
              n["mix_numel"], n["n_slots"])

    def conv(ke, he, g, per):
        c = list(common)
        c[1] = he
        return TC.fwd_regions(ke, *c, g, per)

    plans = (conv(n["gs_n"] + n["nb"], n["he_lig"], g_l, n["nl"]),
             conv(n["gs_n"], n["he_cross"], g_l, n["na"]),
             conv(n["gs_n"], n["he_atom"], g_a, n["k"]),
             conv(n["gs_n"], n["he_cross"], g_a, n["nl"]))
    return sum(max(r) for r in zip(*plans))


def row_groups(ints: dict):
    """(g_l, g_a): ligand rows per ligand-row block and atoms per atom-row
    block; LIG_ROWS and ATOM_ROWS, halved (atoms first) until the block's
    shared memory fits the card's."""
    g_l, g_a = LIG_ROWS, ATOM_ROWS
    while plan_words(ints, g_l, g_a) > SMEM_WORDS and g_a > 1:
        g_a //= 2
    while plan_words(ints, g_l, g_a) > SMEM_WORDS and g_l > 1:
        g_l //= 2
    if plan_words(ints, g_l, g_a) > SMEM_WORDS:
        raise ValueError("layer_conv: one trunk layer's tile does not fit the shared memory")
    return g_l, g_a


def _dense_masks(lig_pos, atm_pos, lig_mask, atm_mask, cab, lig_cut, cross_cutoff, bond_mask):
    """The pair conv's and the cross conv's valid pairs, [B, nl, nl] and
    [B, nl, na], as the kernel decides them (compact_pairs, dense_valid):
    target and source unmasked, and (CA/CB flag or within the cutoff, self
    excluded for the pair conv) or bonded."""
    bsz, dev = lig_pos.shape[0], lig_pos.device
    pair = TC.pair_valid(lig_pos, lig_pos, lig_mask, lig_mask, torch.zeros_like(lig_mask),
                         TC._cutoffs(lig_cut, bsz, dev), bond_mask)
    return pair, TC.cross_valid(lig_pos, atm_pos, lig_mask, atm_mask, cab,
                                TC._cutoffs(cross_cutoff, bsz, dev))


def layer_tile_plan(lig_pos, atm_pos, lig_mask, atm_mask, cab, lig_cut, cross_cutoff, bond_mask,
                    atm_idx, atm_valid, g_l=LIG_ROWS, g_a=ATOM_ROWS):
    """B10's blocks in grid order (the ligand-row blocks of every sample,
    then the atom-row blocks), each with its targets' valid pairs in
    candidate order (target-major; then source index, or neighbour slot for
    the knn conv) cut into tiles of WIDE_TILE."""
    bsz, nl, na = lig_pos.shape[0], lig_pos.shape[1], atm_pos.shape[1]
    pair, cross = _dense_masks(lig_pos, atm_pos, lig_mask, atm_mask, cab, lig_cut, cross_cutoff,
                               bond_mask)
    idx = atm_idx.long()
    masks = {"lig": pair, "al": cross, "la": cross.transpose(1, 2),
             "atom": TC.knn_valid(idx, atm_valid)}
    blocks = []
    for kind, convs, n, g in (("lig", ("lig", "al"), nl, g_l), ("atom", ("atom", "la"), na, g_a)):
        for b in range(bsz):
            for t0 in range(0, n, g):
                tiles = {tag: TC.block_tiles(masks[tag][b, t0 : t0 + g], t0,
                                             idx[b, t0 : t0 + g] if tag == "atom" else None)
                         for tag in convs}
                blocks.append(TC.TileBlock(kind, b, t0, g, tiles))
    return blocks


def layer_conv_tiled_plain(lc: LayerConsts, lig_pos, atm_pos, lig_cm, atm_cm, lig_mask, atm_mask,
                           cab, temb, cross_cutoff, bond_feat, bond_mask, atm_idx, atm_valid,
                           cnt_lig, cnt_al, cnt_la, cnt_atm, params, groups=(LIG_ROWS, ATOM_ROWS)):
    """B10's decomposition, plain: the blocks of layer_tile_plan, each conv's
    tiles in list order, every pair's message (trunk_convs.wide_tile_plain,
    on the kernel's folded edge inputs) added to its target's sum tile by
    tile; then the finalizes and the residual ladder of layer_conv_plain.
    Same returns as layer_conv_plain."""
    bsz, nl, na = lig_cm.shape[0], lig_cm.shape[1], atm_cm.shape[1]
    nb = bond_feat.shape[-1]
    p = {k: TC._f32(v) for k, v in params.items()}
    temb = temb.float()
    edges = {"lig": (lc.lig, "emb_lig", nb), "al": (lc.cross, "emb_cross", 0),
             "la": (lc.cross, "emb_cross", 0), "atom": (lc.atom, "emb_atom", 0)}
    sides = {"lig": (lig_pos, lig_pos, lig_cm, lig_cm, nl), "al": (lig_pos, atm_pos, lig_cm,
                                                                   atm_cm, nl),
             "la": (atm_pos, lig_pos, atm_cm, lig_cm, na), "atom": (atm_pos, atm_pos, atm_cm,
                                                                    atm_cm, na)}
    folded = {tag: TC._prep_edge(c, p[e]["l1"]["w"], p[e]["l1"]["b"], temb, extra, bsz,
                                 lig_cm.device) for tag, (c, e, extra) in edges.items()}
    sums = {tag: lig_cm.new_zeros(bsz, sides[tag][4], lc.lig.dout) for tag in edges}
    for blk in layer_tile_plan(lig_pos, atm_pos, lig_mask, atm_mask, cab, lc.lig.gs_stop,
                               cross_cutoff, bond_mask, atm_idx, atm_valid, *groups):
        b = blk.b
        for tag, tiles in blk.tiles.items():
            c, e, _ = edges[tag]
            tp, sp, tx, sx, _ = sides[tag]
            w_in, beff = folded[tag]
            for tile in tiles:
                t, s = tile[:, 0], tile[:, 1]
                extra = bond_feat[b, t, s].float() if tag == "lig" else None
                vec = sp[b, s] - tp[b, t]
                vec = -vec if tag == "la" else vec  # the kernel's flip: atom - ligand
                sums[tag][b].index_add_(0, t, TC.wide_tile_plain(
                    c, vec, tx[b, t], sx[b, s], extra, w_in, beff[b], p[e], p[f"fc_{tag}"]))
    fin = lc.fin

    def f(tag, cnt):
        return TC.finalize_plain(fin, _fin_params(params, tag), sums[tag], cnt)

    lig_next = pad_to_dim(lig_cm, fin.out_dim) + f("lig", cnt_lig) + f("al", cnt_al)
    atm_next = pad_to_dim(atm_cm, fin.out_dim) + f("atom", cnt_atm) + f("la", cnt_la)
    return lig_next, atm_next


def layer_conv(lc: LayerConsts, lig_pos, atm_pos, lig_cm, atm_cm, lig_mask, atm_mask, cab, temb,
               cross_cutoff, bond_feat, bond_mask, atm_idx, atm_valid, cnt_lig, cnt_al, cnt_la,
               cnt_atm, params):
    """B10: (lig_next [B, nl, out_dim], atm_next [B, na, out_dim]) in one
    launch on CUDA tensors; the plain version on CPU tensors."""
    args = (lc, lig_pos, atm_pos, lig_cm, atm_cm, lig_mask, atm_mask, cab, temb, cross_cutoff,
            bond_feat, bond_mask, atm_idx, atm_valid, cnt_lig, cnt_al, cnt_la, cnt_atm, params)
    if not lig_cm.is_cuda:
        return layer_conv_plain(*args)
    return TC._with_plain_backward(_layer_kernel, layer_conv_plain, *args)


# what the last layer_conv launch on the card used: rows per block (g_l,
# g_a) and the block's shared memory (chip_smoke.py reports them)
layer_conv_stats: dict = {}


def _layer_kernel(lc, lig_pos, atm_pos, lig_cm, atm_cm, lig_mask, atm_mask, cab, temb,
                  cross_cutoff, bond_feat, bond_mask, atm_idx, atm_valid, cnt_lig, cnt_al, cnt_la,
                  cnt_atm, params, cycles=None):
    """One launch of csrc/layer_conv.cu. `cycles`, an int64 tensor of one
    entry per block (layer_tile_plan's order), receives each block's
    clock64() cycles (chip_smoke.py's share of each kind of block)."""
    fin, dev = lc.fin, lig_cm.device
    zero = torch.zeros_like(lig_mask)
    # the three convs' validated inputs and folded edge MLPs (trunk_convs)
    pd, lx, _, p_win, p_beff, p_w2, p_b2, *p_fc = TC._pair_inputs(
        lc.lig, lig_pos, lig_pos, lig_cm, lig_cm, lig_mask, lig_mask, zero, temb, lc.lig.gs_stop,
        TC.pair_params(params["emb_lig"], params["fc_lig"]), bond_feat, bond_mask)
    cd, _, ax, c_win, c_beff, c_w2, c_b2, *c_fc = TC._cross_inputs(
        lc.cross, lig_pos, atm_pos, lig_cm, atm_cm, lig_mask, atm_mask, cab, temb,
        cross_cutoff, params["emb_cross"], params["fc_al"], params["fc_la"])
    kd, _, k_win, k_beff, k_w2, k_b2, *k_fc = TC._knn_inputs(
        lc.atom, atm_pos, atm_cm, atm_idx, atm_valid, temb,
        {"emb": params["emb_atom"], "fc": params["fc_atom"]})
    bsz, nl, na = lx.shape[0], lx.shape[1], ax.shape[1]
    k = kd.idx.shape[-1]
    for c in (lc.cross, lc.atom):
        if c.spec != lc.lig.spec or c.gs_n != lc.lig.gs_n or c.ns != lc.lig.ns:
            raise ValueError("layer_conv: the three convs must share one TP spec and widths")
    he_l, hf, nw, kdim = pd.dims
    if (cd.dims[1:], kd.dims[1:]) != ((hf, nw, kdim), (hf, nw, kdim)):
        raise ValueError("layer_conv: the four TP-weight MLPs must share their widths")
    ck, _, out_meta = lc.lig.device_tables(dev)
    mix_meta, ln_slots = fin.device_tables(dev)
    out_lig = torch.empty(bsz, nl, fin.out_dim, dtype=torch.float32, device=dev)
    out_atm = torch.empty(bsz, na, fin.out_dim, dtype=torch.float32, device=dev)
    t = {"lig_pos": pd.tgt_pos, "atm_pos": cd.atm_pos, "lig_x": lx, "atm_x": ax,
         "lig_mask": pd.tgt_mask, "atm_mask": cd.atm_mask, "cab": cd.cab, "lig_cut": pd.cut,
         "cross_cut": cd.cut, "bond_feat": pd.bond_feat, "bond_mask": pd.bond_mask,
         "knn_idx": kd.idx, "knn_valid": kd.valid, "ck": ck, "out_meta": out_meta,
         "gs_lig": lc.lig.device_tables(dev)[1], "gs_cross": lc.cross.device_tables(dev)[1],
         "gs_atom": lc.atom.device_tables(dev)[1], "mix_meta": mix_meta, "ln_slots": ln_slots,
         "out_lig": out_lig, "out_atm": out_atm, "cycles": cycles}
    for e, ws in (("emb_lig", (p_win, p_beff, p_w2, p_b2)), ("emb_cross", (c_win, c_beff, c_w2,
                                                                          c_b2)),
                  ("emb_atom", (k_win, k_beff, k_w2, k_b2))):
        t.update({f"{e}_{w}": v for w, v in zip(("w_in", "beff", "w2", "b2"), ws)})
    rows = {"lig": (bsz, nl), "al": (bsz, nl), "la": (bsz, na), "atom": (bsz, na)}
    fcs = {"lig": p_fc, "al": c_fc[:4], "la": c_fc[4:], "atom": k_fc}
    cnts = {"lig": cnt_lig, "al": cnt_al, "la": cnt_la, "atom": cnt_atm}
    for tag in ("lig", "al", "la", "atom"):
        t.update({f"{tag}_{w}": v for w, v in zip(("w1", "b1", "w2", "b2"), fcs[tag])})
        _, ts = TC._fin_ptrs(fin, _fin_params(params, tag), cnts[tag], rows[tag], dev)
        t.update({f"{tag}_{w}": v for w, v in zip(("cnt", "mix", "ln_w", "ln_ms", "ln_b"), ts)})
    ints = {"batch": bsz, "nl": nl, "na": na, "k": k, "din": lc.lig.din, "dout": lc.lig.dout,
            "nb": pd.nb, "ns": lc.lig.ns, "he_lig": he_l, "he_cross": cd.dims[0],
            "he_atom": kd.dims[0], "hf": hf, "nw": nw, "kdim": kdim, "gs_n": lc.lig.gs_n,
            "out_dim": fin.out_dim, "n_slots": len(fin.spec.out.items),
            "mix_numel": fin.spec.lin.weight_numel}
    g_l, g_a = ints["lig_rows"], ints["atom_rows"] = row_groups(ints)
    layer_conv_stats.update(groups=(g_l, g_a), smem_bytes=4 * plan_words(ints, g_l, g_a))
    if cycles is not None and (cycles.dtype != torch.int64 or cycles.device != dev
                               or cycles.numel() != bsz * (-(-nl // g_l) - (-na // g_a))):
        raise ValueError("layer_conv: cycles takes one int64 per block on the kernel's device")
    floats = {"gs_coeff_lig": lc.lig.gs_coeff, "gs_coeff_cross": lc.cross.gs_coeff,
              "gs_coeff_atom": lc.atom.gs_coeff}
    ptr_arr = (ctypes.c_void_p * len(PTRS))(*[TC._ptr(t[n]) for n in PTRS])
    int_arr = (ctypes.c_int * len(INTS))(*[int(ints[n]) for n in INTS])
    float_arr = (ctypes.c_float * len(FLOATS))(*[float(floats[n]) for n in FLOATS])
    rc = TC._library().dbfr_layer_conv(ptr_arr, len(PTRS), int_arr, len(INTS), float_arr,
                                       len(FLOATS), TC._stream())
    TC._check(rc, "layer_conv")
    TC.launches["layer_conv"] += 1
    return out_lig, out_atm

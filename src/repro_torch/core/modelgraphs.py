"""Synthetic cost graphs of the paper's five models (Table 3).

The paper partitions TensorFlow graphs of Word-RNN, Char-CRN, WRN, TRN and
E3D-LSTM profiled on V100s. Re-profiling TF1 on GPUs is out of scope here;
instead we *generate* the computational DAGs from the architecture specs —
same operator structure (fork-joins of heads/experts/residual branches,
unrolled recurrences), costs from the analytic device model (FLOPs →
seconds, output bytes → memory, edge bytes → comm). Node counts land in
the paper's ranges (Table 3: 10k-190k nodes).

All generators emit *training* graphs: forward ops, mirrored backward ops
(each consuming its forward activation — the source of memory pressure),
weight-gradient ops and in-place update ops (``ref_ns``) co-located with
their variables (``res_ns``).
"""
from __future__ import annotations

import numpy as np

from .costmodel import DeviceModel, V100
from .graph import CostGraph, NORMAL, REF, RESIDUAL

F32 = 4  # bytes


class _B:
    """Tiny builder: tracks variables and forward nodes for autograd mirror."""

    def __init__(self, dev: DeviceModel):
        self.g = CostGraph()
        self.dev = dev
        self.fwd_nodes: list[int] = []
        self.var_nodes: list[int] = []

    def var(self, nbytes: float, name: str = "var") -> int:
        nid = self.g.add_node(comp=0.0, mem=nbytes, ntype=RESIDUAL, name=name)
        self.var_nodes.append(nid)
        return nid

    def op(self, flops: float, out_bytes: float, deps: list[int],
           name: str = "op", dep_bytes: float | None = None) -> int:
        # roofline op time: touched bytes include any weight operands —
        # this is what makes small batches memory-bound (weight reads not
        # amortized) and reproduces the paper's utilization-driven
        # superlinear batch scaling (§5.3)
        touched = out_bytes + sum(
            self.g.mem[d] for d in deps if self.g.ntype[d] == RESIDUAL)
        comp = self.dev.compute_seconds(flops, touched)
        nid = self.g.add_node(comp=comp, mem=out_bytes, ntype=NORMAL,
                              name=name)
        for d in deps:
            b = dep_bytes if dep_bytes is not None else self.g.mem[d]
            self.g.add_edge(d, nid, comm=self.dev.comm_seconds(b))
        self.fwd_nodes.append(nid)
        return nid

    def finish_with_backward(self, loss_node: int) -> CostGraph:
        """Mirror the forward graph: grad node per fwd op (reversed edges +
        an activation edge from the fwd op), update op per variable."""
        g = self.g
        grad_of: dict[int, int] = {}
        # walk forward nodes in reverse topological (creation) order
        for u in reversed(self.fwd_nodes):
            gn = g.add_node(comp=2.0 * g.comp[u], mem=g.mem[u], ntype=NORMAL,
                            name=f"grad_{g.names[u]}")
            grad_of[u] = gn
            # activation dependency: backward needs the fwd output
            g.add_edge(u, gn, comm=self.dev.comm_seconds(g.mem[u]))
        # reversed data edges between grad nodes
        for u in self.fwd_nodes:
            gu = grad_of[u]
            for v, c in list(g.out_edges[u]):
                if v in grad_of:
                    g.add_edge(grad_of[v], gu, comm=c)
        # weight grads + updates (ref_ns co-located with the variable)
        for w in self.var_nodes:
            consumers = [v for v, _ in g.out_edges[w] if v in grad_of]
            if not consumers:
                continue
            wb = g.mem[w]
            gw = g.add_node(comp=self.dev.compute_seconds(wb / F32, wb),
                            mem=wb, ntype=NORMAL, name=f"grad_{g.names[w]}")
            for cns in consumers[:4]:
                g.add_edge(grad_of[cns], gw,
                           comm=self.dev.comm_seconds(g.mem[cns]))
            upd = g.add_node(comp=self.dev.compute_seconds(wb / F32, wb),
                             mem=0.0, ntype=REF, name=f"upd_{g.names[w]}")
            g.add_edge(gw, upd, comm=self.dev.comm_seconds(wb))
            g.add_edge(w, upd, comm=0.0)
            g.colocate_with[upd] = w
        return g.finalize()


def word_rnn(layers: int = 8, hidden: int = 2048, seq: int = 28,
             batch: int = 16, vocab: int = 20000,
             dev: DeviceModel = V100, ops_per_cell: int = 9) -> CostGraph:
    """Stacked-LSTM word LM [58]. Graph: seq × layers unrolled LSTM cells,
    each a fork-join of gate ops; high DoP across timesteps of different
    layers (the paper's wavefront)."""
    b = _B(dev)
    H, Bz = hidden, batch
    emb = b.var(vocab * H * F32, "embedding")
    wx = [b.var(H * 4 * H * F32, f"wx{l}") for l in range(layers)]
    wh = [b.var(H * 4 * H * F32, f"wh{l}") for l in range(layers)]
    act_b = Bz * H * F32
    x_prev = [b.op(Bz * H, act_b, [emb], f"lookup_t0")] * 1
    # state chains
    h = [[-1] * (seq + 1) for _ in range(layers)]
    c = [[-1] * (seq + 1) for _ in range(layers)]
    inp = [b.op(Bz * H, act_b, [emb], f"lookup_t{t}") for t in range(seq)]
    for t in range(seq):
        below = inp[t]
        for l in range(layers):
            deps_x = [below, wx[l]]
            mm_x = b.op(2 * Bz * H * 4 * H, Bz * 4 * H * F32, deps_x,
                        f"mmx_l{l}_t{t}")
            deps_h = [wh[l]] + ([h[l][t]] if h[l][t] >= 0 else [])
            mm_h = b.op(2 * Bz * H * 4 * H, Bz * 4 * H * F32, deps_h,
                        f"mmh_l{l}_t{t}")
            gates = b.op(Bz * 4 * H, Bz * 4 * H * F32, [mm_x, mm_h],
                         f"gates_l{l}_t{t}")
            # fork: per-gate activations
            parts = [b.op(Bz * H, act_b, [gates], f"gate{i}_l{l}_t{t}")
                     for i in range(max(ops_per_cell - 5, 2))]
            cdeps = parts + ([c[l][t]] if c[l][t] >= 0 else [])
            c_new = b.op(Bz * H, act_b, cdeps, f"c_l{l}_t{t}")
            h_new = b.op(Bz * H, act_b, [c_new], f"h_l{l}_t{t}")
            h[l][t + 1] = h_new
            c[l][t + 1] = c_new
            below = h_new
    proj_w = b.var(H * vocab * F32, "proj")
    logits = b.op(2 * Bz * H * vocab, Bz * vocab * F32,
                  [h[layers - 1][seq], proj_w], "logits")
    loss = b.op(Bz * vocab, F32, [logits], "loss")
    return b.finish_with_backward(loss)


def char_crn(layers: int = 8, hidden: int = 2048, seq: int = 15,
             batch: int = 8, filters: int = 512, dev: DeviceModel = V100
             ) -> CostGraph:
    """Character-aware LM [32]: char-CNN (many parallel filter widths —
    huge DoP) + highway + stacked LSTM."""
    b = _B(dev)
    H, Bz = hidden, batch
    widths = [1, 2, 3, 4, 5, 6, 7]
    conv_ws = [b.var(w * 15 * filters * F32, f"convw{w}") for w in widths]
    act = Bz * filters * F32
    per_t_feats = []
    for t in range(seq):
        branches = []
        for wi, w in enumerate(widths):
            cv = b.op(2 * Bz * w * 15 * filters * 64, act,
                      [conv_ws[wi]], f"conv{w}_t{t}")
            mx = b.op(Bz * filters, act, [cv], f"maxpool{w}_t{t}")
            branches.append(mx)
        cat = b.op(Bz * H, Bz * H * F32, branches, f"concat_t{t}")
        hw_w = conv_ws[0]
        hw = b.op(2 * Bz * H * H, Bz * H * F32, [cat, hw_w], f"highway_t{t}")
        per_t_feats.append(hw)
    wx = [b.var(H * 4 * H * F32, f"wx{l}") for l in range(layers)]
    wh = [b.var(H * 4 * H * F32, f"wh{l}") for l in range(layers)]
    h = [[-1] * (seq + 1) for _ in range(layers)]
    for t in range(seq):
        below = per_t_feats[t]
        for l in range(layers):
            mm_x = b.op(2 * Bz * H * 4 * H, Bz * 4 * H * F32, [below, wx[l]],
                        f"mmx_l{l}_t{t}")
            hdeps = [wh[l]] + ([h[l][t]] if h[l][t] >= 0 else [])
            mm_h = b.op(2 * Bz * H * 4 * H, Bz * 4 * H * F32, hdeps,
                        f"mmh_l{l}_t{t}")
            cell = b.op(Bz * 8 * H, Bz * H * F32, [mm_x, mm_h],
                        f"cell_l{l}_t{t}")
            h[l][t + 1] = cell
            below = cell
    vocab = 10000
    pw = b.var(H * vocab * F32, "proj")
    logits = b.op(2 * Bz * H * vocab, Bz * vocab * F32,
                  [h[layers - 1][seq], pw], "logits")
    loss = b.op(Bz * vocab, F32, [logits], "loss")
    return b.finish_with_backward(loss)


def wrn(residual_units: int = 101, widen: int = 14, batch: int = 1,
        base_ch: int = 16, img: int = 32, dev: DeviceModel = V100
        ) -> CostGraph:
    """Wide ResNet [70]: 3 groups of residual units; channels ×widen."""
    b = _B(dev)
    Bz = batch
    x = b.var(Bz * 3 * img * img * F32, "input")
    prev = b.op(2 * Bz * 9 * 3 * base_ch * img * img,
                Bz * base_ch * img * img * F32, [x], "stem")
    ch = base_ch
    res = img
    per_group = max(residual_units // 3, 1)
    for gi, mult in enumerate((1, 2, 4)):
        out_ch = base_ch * mult * widen
        for ui in range(per_group):
            stride = 2 if (ui == 0 and gi > 0) else 1
            if stride == 2:
                res //= 2
            act_bytes = Bz * out_ch * res * res * F32
            w1 = b.var(9 * ch * out_ch * F32, f"w1_g{gi}u{ui}")
            w2 = b.var(9 * out_ch * out_ch * F32, f"w2_g{gi}u{ui}")
            bn1 = b.op(Bz * ch * res * res, Bz * ch * res * res * F32,
                       [prev], f"bn1_g{gi}u{ui}")
            c1 = b.op(2 * Bz * 9 * ch * out_ch * res * res, act_bytes,
                      [bn1, w1], f"conv1_g{gi}u{ui}")
            bn2 = b.op(Bz * out_ch * res * res, act_bytes, [c1],
                       f"bn2_g{gi}u{ui}")
            c2 = b.op(2 * Bz * 9 * out_ch * out_ch * res * res, act_bytes,
                      [bn2, w2], f"conv2_g{gi}u{ui}")
            # shortcut join (fork at prev, join here)
            add = b.op(Bz * out_ch * res * res, act_bytes, [c2, prev],
                       f"add_g{gi}u{ui}")
            prev = add
            ch = out_ch
    pw = b.var(ch * 100 * F32, "fc")
    pooled = b.op(Bz * ch, Bz * ch * F32, [prev], "pool")
    logits = b.op(2 * Bz * ch * 100, Bz * 100 * F32, [pooled, pw], "logits")
    loss = b.op(Bz * 100, F32, [logits], "loss")
    return b.finish_with_backward(loss)


def trn(layers: int = 24, d_model: int = 2048, d_ff: int = 5120,
        heads: int = 16, seq: int = 64, batch: int = 1,
        vocab: int = 32768, dev: DeviceModel = V100) -> CostGraph:
    """Transformer [61] with explicit per-head fork-join (the TF1 graph has
    one matmul chain per head — the DoP the paper exploits)."""
    b = _B(dev)
    Bz, S, D, Hh = batch, seq, d_model, heads
    dh = D // Hh
    emb = b.var(vocab * D * F32, "embedding")
    prev = b.op(Bz * S * D, Bz * S * D * F32, [emb], "embed")
    for l in range(layers):
        wq = b.var(D * D * F32, f"wq{l}")
        wk = b.var(D * D * F32, f"wk{l}")
        wv = b.var(D * D * F32, f"wv{l}")
        wo = b.var(D * D * F32, f"wo{l}")
        w1 = b.var(D * d_ff * F32, f"w1_{l}")
        w2 = b.var(d_ff * D * F32, f"w2_{l}")
        ln = b.op(Bz * S * D, Bz * S * D * F32, [prev], f"ln1_{l}")
        q = b.op(2 * Bz * S * D * D, Bz * S * D * F32, [ln, wq], f"q{l}")
        kk = b.op(2 * Bz * S * D * D, Bz * S * D * F32, [ln, wk], f"k{l}")
        v = b.op(2 * Bz * S * D * D, Bz * S * D * F32, [ln, wv], f"v{l}")
        head_outs = []
        for hh in range(Hh):
            sc = b.op(2 * Bz * S * S * dh, Bz * S * S * F32, [q, kk],
                      f"scores_l{l}h{hh}")
            sm = b.op(Bz * S * S, Bz * S * S * F32, [sc], f"smax_l{l}h{hh}")
            av = b.op(2 * Bz * S * S * dh, Bz * S * dh * F32, [sm, v],
                      f"attnv_l{l}h{hh}")
            head_outs.append(av)
        cat = b.op(Bz * S * D, Bz * S * D * F32, head_outs, f"concat{l}")
        proj = b.op(2 * Bz * S * D * D, Bz * S * D * F32, [cat, wo],
                    f"proj{l}")
        res1 = b.op(Bz * S * D, Bz * S * D * F32, [proj, prev], f"res1_{l}")
        ln2 = b.op(Bz * S * D, Bz * S * D * F32, [res1], f"ln2_{l}")
        ff1 = b.op(2 * Bz * S * D * d_ff, Bz * S * d_ff * F32, [ln2, w1],
                   f"ff1_{l}")
        ff2 = b.op(2 * Bz * S * d_ff * D, Bz * S * D * F32, [ff1, w2],
                   f"ff2_{l}")
        prev = b.op(Bz * S * D, Bz * S * D * F32, [ff2, res1], f"res2_{l}")
    pw = b.var(D * vocab * F32, "proj_out")
    logits = b.op(2 * Bz * S * D * vocab, Bz * S * vocab * F32, [prev, pw],
                  "logits")
    loss = b.op(Bz * S * vocab, F32, [logits], "loss")
    return b.finish_with_backward(loss)


def e3d(hidden: int = 320, filt: int = 5, patch: int = 4, seq: int = 10,
        layers: int = 4, batch: int = 1, img: int = 64,
        dev: DeviceModel = V100) -> CostGraph:
    """Eidetic-3D LSTM [65]: conv-LSTM with 3D convolutions + eidetic
    attention over past cell states (recall gate) — recurrent fork-joins."""
    b = _B(dev)
    Bz = batch
    res = img // patch
    C = hidden
    vox = Bz * C * res * res * 2  # 3D: depth window of 2
    act = vox * F32
    ws = [b.var(filt ** 3 * C * C * 7 * F32, f"w3d_{l}") for l in range(layers)]
    x = b.var(Bz * patch * patch * res * res * F32, "frames")
    h = [[-1] * (seq + 1) for _ in range(layers)]
    cells: list[list[int]] = [[] for _ in range(layers)]
    for t in range(seq):
        below = b.op(vox, act, [x], f"patchify_t{t}")
        for l in range(layers):
            deps = [below, ws[l]] + ([h[l][t]] if h[l][t] >= 0 else [])
            conv = b.op(2 * filt ** 3 * C * C * 7 * Bz * res * res * 2,
                        act * 7, deps, f"conv3d_l{l}t{t}")
            gates = [b.op(vox, act, [conv], f"g{i}_l{l}t{t}")
                     for i in range(5)]
            # eidetic attention: recall over all past cell states (join!)
            att_deps = gates[:2] + cells[l][-8:]
            recall = b.op(2 * vox * max(len(cells[l]), 1), act, att_deps,
                          f"recall_l{l}t{t}")
            c_new = b.op(vox, act, [recall] + gates[2:4], f"c_l{l}t{t}")
            h_new = b.op(vox, act, [c_new, gates[4]], f"h_l{l}t{t}")
            cells[l].append(c_new)
            h[l][t + 1] = h_new
            below = h_new
    dec_w = b.var(C * patch * patch * F32, "dec")
    out = b.op(2 * vox * patch * patch, Bz * img * img * F32,
               [h[layers - 1][seq], dec_w], "decode")
    loss = b.op(Bz * img * img, F32, [out], "loss")
    return b.finish_with_backward(loss)


# Table-3 configurations (node counts approximate the paper's graph sizes)
PAPER_MODELS = {
    "word-rnn":   lambda **kw: word_rnn(layers=8, hidden=2048, seq=28, **kw),
    "word-rnn-2": lambda **kw: word_rnn(layers=8, hidden=4096, seq=25, **kw),
    "char-crn":   lambda **kw: char_crn(layers=8, hidden=2048, seq=15, **kw),
    "char-crn-2": lambda **kw: char_crn(layers=32, hidden=2048, seq=15, **kw),
    "wrn":        lambda **kw: wrn(residual_units=101, widen=14, **kw),
    "wrn-2":      lambda **kw: wrn(residual_units=50, widen=28, **kw),
    "trn":        lambda **kw: trn(layers=24, d_model=2048, d_ff=5120, **kw),
    "trn-2":      lambda **kw: trn(layers=48, d_model=2048, d_ff=8192, **kw),
    "e3d":        lambda **kw: e3d(hidden=320, filt=5, patch=4, **kw),
    "e3d-2":      lambda **kw: e3d(hidden=512, filt=5, patch=8, **kw),
}

"""The sharded RUNS update step (K11) on a mesh of devices or processes.

The counterpart of ``bossruns_tpu.parallel.mesh``. The genome is the long
axis: all per-site and per-ds-row state splits into contiguous blocks over
the mesh's genome axis ``g`` (Sg shards), and the barcode axis optionally
over ``b`` (Sb shards). Read batches are replicated; each shard keeps the
rows that land in its block. Shard (bi, gi) holds barcodes [bi*nb_l,
(bi+1)*nb_l) and sites [gi*Gl, (gi+1)*Gl), and a mesh lists its shards
row-major, as the JAX package's ``make_mesh`` lays out its devices.

A mesh comes in two forms with one step body:

  * ``make_mesh``: one process holds all Sb*Sg shards, each on a
    ``torch.device`` from a list that may repeat one device (the shards of
    one device run in turn and share its scratch memory). The counterpart
    of a single-process JAX mesh and of its virtual CPU devices.
  * ``process_group_mesh``: one shard per rank of the ``torch.distributed``
    group that ``distributed.init_from_env`` joined, with subgroups along
    ``g`` and ``b``.

The step body (``ShardedRunsEngine._step_local``) is written once against
the collectives of ``Comm``: sum or max over g, b or both, an all-gather
along g, and the two halo shifts (plus, under ``debug_aux``, a gather of
every shard's scores). Each collective takes the list of local
shard tensors. The kernels are H1, H2, H3 and H4 through their shard entry
points (``ops.genome_ops.shard_coverage``, ``shard_rows``,
``shard_benefit``: kernel H8) and H2 per shard.

On one card, the in-process mesh's step is captured as the single engine's
is (models/graphs.py): one CUDA graph per batch-shape tier over every local
shard and its collectives (``torch.stack`` and copies on one device),
replayed from the tier's second step on. The process-group mesh stays
eager: its collectives are host calls into ``torch.distributed``. So does
an in-process mesh over several devices, and any step under ``probe``.

Exactness (the JAX contract, mesh.py:26-31): every sum across shards is of
integers (coverage, buckets, contig means, bin counts; reduced as int64) or
of f32-rounded values in f64 (scores, fhat weights, ubar0 products), and
the in-process mesh sums in shard order. The benefit cumsum takes the
exclusive prefix of the all-gathered 4096-row tile totals, so when the
shard bounds fall on tiles it equals the single-device scan bit for bit.
Layouts must be built with ``align_chunks = Sg`` so every shard gets whole
chunks. The engine options keep this: their only sum that is not exact
across shards is that cumsum (f64 scores, or the f32 decision path), so
there the sharded step equals the single one when the shard bounds fall on
4096-row tiles (``align_chunks = 4 * Sg``, or a chunk count that 4 * Sg
divides, as chip_smoke.py's 8.05 Mb and chromosome meshes have).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..models.layout import DS, GenomeLayout, build_layout
from ..models.runs import GenomeState, ReadBatch, RunsConfig, RunsEngine, StepAux, StepParams
from ..ops import genome_ops as gops
from ..ops.genome_ops import local_ex_indices, local_run_indices
from ..ops.scores import ScoreTables, site_scores
from . import distributed

__all__ = [
    "Comm", "InProcessComm", "Mesh", "ProcessGroupComm", "ShardedRunsEngine",
    "demo_sharded_step", "local_ex_indices", "local_run_indices", "make_mesh",
    "process_group_mesh",
]


# ------------------------------------------------------------ collectives --

class Comm:
    """The collectives of the step body over a (Sb, Sg) mesh. Every method
    takes the list of this process's shard tensors, in the mesh's local
    order, and updates them in place (``sum``, ``max``) or returns one new
    tensor per shard (``gather_g``, ``shift_g``). Tensors are int32, int64,
    float32 or float64 (collective backends do not reduce uint16 or bool)."""

    def __init__(self, Sb: int, Sg: int, coords: list[tuple[int, int]]):
        self.Sb, self.Sg, self.coords = Sb, Sg, coords

    def sum(self, xs: list[torch.Tensor], axis: str) -> None:
        raise NotImplementedError

    def max(self, xs: list[torch.Tensor], axis: str) -> None:
        raise NotImplementedError

    def gather_g(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Per shard: the tensors of its g-row, stacked in shard order [Sg, ...]."""
        raise NotImplementedError

    def shift_g(self, xs: list[torch.Tensor], step: int) -> list[torch.Tensor]:
        """Per shard (bi, gi): the tensor of shard (bi, gi - step), or zeros
        where that shard does not exist (step +1: from the left neighbour,
        -1: from the right one)."""
        raise NotImplementedError

    def gather_all(self, xs: list[torch.Tensor]) -> list[np.ndarray]:
        """Every shard's tensor of the whole mesh as NumPy, in flat order
        (bi*Sg + gi), on every process."""
        raise NotImplementedError

    def gather_mesh(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """Every shard's tensor of the whole mesh, stacked in flat order
        (bi*Sg + gi) into one [Sb*Sg, ...] tensor on the device of this
        process's first shard, on every process."""
        raise NotImplementedError


def _members(Sb: int, Sg: int, b: int, g: int, axis: str) -> list[int]:
    """Flat indices (bi*Sg + gi) of the shards reduced with (b, g) along axis."""
    if axis == "g":
        return [b * Sg + k for k in range(Sg)]
    if axis == "b":
        return [k * Sg + g for k in range(Sb)]
    if axis == "both":
        return list(range(Sb * Sg))
    raise ValueError(f"unknown mesh axis {axis!r}")


class InProcessComm(Comm):
    """All shards in this process: reductions run in shard order."""

    def _reduce(self, xs, axis, op):
        flat = {b * self.Sg + g: x for (b, g), x in zip(self.coords, xs)}
        out = {}
        for (b, g), x in zip(self.coords, xs):
            m = tuple(_members(self.Sb, self.Sg, b, g, axis))
            if m not in out:
                acc = flat[m[0]].clone()
                for k in m[1:]:
                    acc = op(acc, flat[k].to(acc.device))
                out[m] = acc
            x.copy_(out[m].to(x.device))

    def sum(self, xs, axis):
        self._reduce(xs, axis, torch.add)

    def max(self, xs, axis):
        self._reduce(xs, axis, torch.maximum)

    def gather_g(self, xs):
        flat = {b * self.Sg + g: x for (b, g), x in zip(self.coords, xs)}
        return [torch.stack([flat[k].to(x.device) for k in _members(self.Sb, self.Sg, b, g, "g")])
                for (b, g), x in zip(self.coords, xs)]

    def shift_g(self, xs, step):
        flat = {b * self.Sg + g: x for (b, g), x in zip(self.coords, xs)}
        out = []
        for (b, g), x in zip(self.coords, xs):
            src = g - step
            out.append(flat[b * self.Sg + src].to(x.device).clone() if 0 <= src < self.Sg
                       else torch.zeros_like(x))
        return out

    def gather_all(self, xs):
        flat = {b * self.Sg + g: x for (b, g), x in zip(self.coords, xs)}
        return [flat[k].cpu().numpy() for k in range(self.Sb * self.Sg)]

    def gather_mesh(self, xs):
        flat = {b * self.Sg + g: x for (b, g), x in zip(self.coords, xs)}
        return torch.stack([flat[k].to(xs[0].device) for k in range(self.Sb * self.Sg)])


class ProcessGroupComm(Comm):
    """One shard per rank (rank = bi*Sg + gi) of the default process group;
    subgroups along g and b. Every rank creates every subgroup, in the same
    order, as ``torch.distributed.new_group`` requires."""

    def __init__(self, Sb: int, Sg: int):
        import torch.distributed as dist

        rank = dist.get_rank()
        if dist.get_world_size() != Sb * Sg:
            raise ValueError(f"a ({Sb}, {Sg}) mesh needs {Sb * Sg} ranks, "
                             f"the group has {dist.get_world_size()}")
        super().__init__(Sb, Sg, [(rank // Sg, rank % Sg)])
        g_groups = [dist.new_group(_members(Sb, Sg, b, 0, "g")) for b in range(Sb)]
        b_groups = [dist.new_group(_members(Sb, Sg, 0, g, "b")) for g in range(Sg)]
        b, g = self.coords[0]
        self.groups = {"g": g_groups[b], "b": b_groups[g], "both": None}

    def _reduce(self, xs, axis, op):
        import torch.distributed as dist

        (x,) = xs
        if axis not in self.groups:
            raise ValueError(f"unknown mesh axis {axis!r}")
        dist.all_reduce(x, op=op, group=self.groups[axis])

    def sum(self, xs, axis):
        import torch.distributed as dist

        self._reduce(xs, axis, dist.ReduceOp.SUM)

    def max(self, xs, axis):
        import torch.distributed as dist

        self._reduce(xs, axis, dist.ReduceOp.MAX)

    def gather_g(self, xs):
        import torch.distributed as dist

        (x,) = xs
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.Sg)]
        dist.all_gather(parts, x, group=self.groups["g"])
        return [torch.stack(parts)]

    def shift_g(self, xs, step):
        # the halos are [nb_l, halo] f64: gathering the g-row and taking the
        # neighbour's costs Sg times the bytes of a send/recv pair, and
        # cannot deadlock
        (x,) = xs
        g = self.coords[0][1]
        src = g - step
        parts = self.gather_g([x])[0]
        return [parts[src].clone() if 0 <= src < self.Sg else torch.zeros_like(x)]

    def gather_all(self, xs):
        (x,) = xs
        return distributed.gather(x)

    def gather_mesh(self, xs):
        (x,) = xs
        return torch.stack(distributed.all_gather_bits(x))  # rank = bi*Sg + gi: flat order


@dataclass
class Mesh:
    """A (Sb, Sg) mesh: the shards this process holds, their devices and
    the collectives that join them."""

    Sb: int
    Sg: int
    coords: list[tuple[int, int]]   # (bi, gi) of each local shard
    devices: list[torch.device]     # one per local shard
    comm: Comm

    @property
    def shape(self) -> dict[str, int]:
        return {"b": self.Sb, "g": self.Sg}

    @property
    def size(self) -> int:
        return self.Sb * self.Sg


def make_mesh(devices, barcode_shards: int = 1) -> Mesh:
    """In-process mesh over ``devices`` (a list that may repeat one device):
    ``barcode_shards`` rows of len(devices) // barcode_shards genome shards."""
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if n % barcode_shards:
        raise ValueError(f"{n} devices do not split into {barcode_shards} barcode shards")
    if len({d.type for d in devs}) != 1:
        raise ValueError("the devices of one mesh must be of one type")
    Sb, Sg = barcode_shards, n // barcode_shards
    coords = [(i // Sg, i % Sg) for i in range(n)]
    return Mesh(Sb, Sg, coords, devs, InProcessComm(Sb, Sg, coords))


def process_group_mesh(barcode_shards: int, genome_shards: int, device) -> Mesh:
    """One shard per rank of the joined process group, on ``device``."""
    comm = ProcessGroupComm(barcode_shards, genome_shards)
    return Mesh(barcode_shards, genome_shards, comm.coords, [torch.device(device)], comm)


# ---------------------------------------------------------------- engine --

@dataclass
class Shard:
    """One shard's place on the global axes and its block of the constants."""

    b: int
    g: int
    device: torch.device
    b0: int      # first global barcode
    g0: int      # first global site
    row0: int    # first global ds row
    c: dict      # name -> constant tensor (genome-axis blocks, replicated tables)
    tables: ScoreTables


class ShardedRunsEngine(RunsEngine):
    """RunsEngine whose step runs shard by shard on a mesh.

    The state is a GenomeState of lists: one tensor per local shard, in the
    mesh's local order (coverage [nb_l, 5, Gl], zeroed [nb_l, Gl],
    bucket_on [nb_l, NBk_pad] (replicated over g), read_starts [Wf_pad, 2]
    (replicated), strat [nb_l, Gdl, 2]). The sharded step is the classic
    flow only, as in the JAX package; ``probe``, when set, is called with
    (wrapper, shard index, args, kwargs) before every kernel call of the
    step (checks and timings of single shards). With ``debug_aux`` the
    step's StepAux carries every shard's post-mask scores gathered into
    one [NB, G_pad] tensor (``gather_scores``), as the single engine's."""

    #: the wire upload and the gated flow target the single-device step
    wire_capable = False

    def __init__(self, layout: GenomeLayout, mesh: Mesh, model=None,
                 config: RunsConfig = RunsConfig()):
        nn.Module.__init__(self)
        Sb, Sg = mesh.Sb, mesh.Sg
        if layout.G_pad % Sg or (layout.G_pad // Sg) % DS:
            raise ValueError(f"G_pad {layout.G_pad} does not split into {Sg} whole-row shards "
                             "(build the layout with align_chunks = genome shards)")
        if layout.n_barcodes % Sb:
            raise ValueError(f"{layout.n_barcodes} barcodes do not split into {Sb} shards")
        consts = self._setup(layout, model, config)
        self.mesh = mesh
        self.Sb, self.Sg = Sb, Sg
        self.Gl = layout.G_pad // Sg
        self.Gdl = self.Gl // DS
        self.nb_l = self.nb // Sb
        self.halo = int(min(self.Gdl, config.ccl_clamp_ds))
        self.device = mesh.devices[0]
        self.probe = None
        self.graphs, self._staging = None, None
        if (isinstance(mesh.comm, InProcessComm) and self.device.type == "cuda"
                and all(d == self.device for d in mesh.devices)):
            from ..models.graphs import GraphCache

            self.graphs = GraphCache(self.device)
        site_axis = ("seq", "site_valid")
        row_axis = ("contig_id_ds", "seg_start", "seg_end", "strat_valid", "fhat_idx",
                    "bucket_idx", "win_id_ds")
        tables = {}
        self.shards: list[Shard] = []
        for (b, g), dev in zip(mesh.coords, mesh.devices):
            g0, row0 = g * self.Gl, g * self.Gdl
            c = {}
            for name, (a, dtype) in consts.items():
                if name in site_axis:
                    a = a[g0: g0 + self.Gl]
                elif name in row_axis:
                    a = a[row0: row0 + self.Gdl]
                c[name] = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)
            if dev not in tables:
                tables[dev] = ScoreTables(self.model, self.dtype, device=dev)
            self.shards.append(Shard(b, g, dev, b * self.nb_l, g0, row0, c, tables[dev]))

    def gather_scores(self, scores: list[torch.Tensor]) -> torch.Tensor:
        """The shards' [nb_l, Gl] scores as one [NB, G_pad] tensor on the
        first local shard's device, on every process (a collective)."""
        t = self.mesh.comm.gather_mesh(scores)               # [Sb*Sg, nb_l, Gl]
        t = t.reshape(self.Sb, self.Sg, self.nb_l, self.Gl).permute(0, 2, 1, 3)
        return t.reshape(self.nb, self.Sg * self.Gl)

    # ------------------------------------------------------------- state ----

    def init_state(self) -> GenomeState:
        """Every state tensor shard by shard: the unsharded [NB, 5, G]
        coverage is never built."""
        lay = self.layout
        fields = {k: [] for k in GenomeState._fields}
        for sh in self.shards:
            d = sh.device
            fields["coverage"].append(
                torch.zeros((self.nb_l, 5, self.Gl), dtype=torch.uint16, device=d))
            fields["zeroed"].append(torch.zeros((self.nb_l, self.Gl), dtype=torch.bool, device=d))
            fields["bucket_on"].append(
                torch.zeros((self.nb_l, lay.NBk_pad), dtype=torch.bool, device=d))
            fields["read_starts"].append(
                torch.zeros((lay.Wf_pad, 2), dtype=self.dtype, device=d))
            fields["strat"].append(
                sh.c["strat_valid"][None, :, None].expand(self.nb_l, self.Gdl, 2).contiguous())
        return GenomeState(**fields)

    def _blocks(self, b: int, g: int) -> dict[str, tuple]:
        """Index of each state field's block of shard (b, g) in the global
        array."""
        bs = slice(b * self.nb_l, (b + 1) * self.nb_l)
        gs = slice(g * self.Gl, (g + 1) * self.Gl)
        rs = slice(g * self.Gdl, (g + 1) * self.Gdl)
        return dict(coverage=(bs, slice(None), gs), zeroed=(bs, gs), bucket_on=(bs,),
                    read_starts=(), strat=(bs, rs))

    def state_from_numpy(self, d: dict) -> GenomeState:
        """Whole-genome state fields as NumPy (a checkpoint, or the JAX or
        single engine's state) -> this engine's shards."""
        ref = RunsEngine.state_from_numpy(self, d, "cpu")
        fields = {k: [] for k in GenomeState._fields}
        for sh in self.shards:
            for k, idx in self._blocks(sh.b, sh.g).items():
                fields[k].append(getattr(ref, k)[idx].to(sh.device, copy=True).contiguous())
        return GenomeState(**fields)

    def state_numpy(self, state: GenomeState, fields=GenomeState._fields) -> dict:
        """The whole-genome state as NumPy, gathered from every shard (a
        collective over the process group: every rank must call it)."""
        lay = self.layout
        shapes = dict(coverage=(self.nb, 5, lay.G_pad), zeroed=(self.nb, lay.G_pad),
                      bucket_on=(self.nb, lay.NBk_pad), read_starts=(lay.Wf_pad, 2),
                      strat=(self.nb, lay.Gd_pad, 2))
        out = {}
        for k in fields:
            parts = self.mesh.comm.gather_all(getattr(state, k))
            full = np.empty(shapes[k], dtype=parts[0].dtype)
            for flat, part in enumerate(parts):
                full[self._blocks(flat // self.Sg, flat % self.Sg)[k]] = part
            out[k] = full
        return out

    def put_batch(self, batch: ReadBatch) -> list[ReadBatch]:
        """The batch on every local shard's device (one copy per device)."""
        per_dev = {}
        out = []
        for sh in self.shards:
            if sh.device not in per_dev:
                per_dev[sh.device] = ReadBatch(*[t.to(sh.device) for t in batch])
            out.append(per_dev[sh.device])
        return out

    def strat_dict(self, state: GenomeState) -> dict[str, np.ndarray]:
        strat = torch.from_numpy(self.state_numpy(state, ("strat",))["strat"])
        return RunsEngine.strat_dict(self, GenomeState(None, None, None, None, strat))

    def step_gated(self, *args, **kw):
        raise NotImplementedError("the sharded step runs the classic flow only")

    def step_from_numpy(self, state: GenomeState, batch_np, params: StepParams):
        """One step from a host batch (numpy): packed, uploaded in one copy
        to the mesh's first device and stepped as ``step`` (the sims keep the
        mesh off the wire: ``wire_capable`` is False)."""
        wire, spec = self.pack_wire(batch_np)
        return self.step(state, self.unpack_wire(torch.from_numpy(wire).to(self.device), spec),
                         params)

    def step(self, state: GenomeState, batch, params: StepParams):
        """One update of every local shard from a ReadBatch (any device) or
        from ``put_batch``'s list. Updates ``state`` in place. On one card
        (in-process mesh, no ``probe``) through the graph cache."""
        batches = batch if isinstance(batch, list) else self.put_batch(batch)
        if self.graphs is None or self.probe is not None:
            return self._step_local(state, batches, params)
        uniq, order = [], []
        for b in batches:
            i = next((k for k, u in enumerate(uniq) if u is b), len(uniq))
            if i == len(uniq):
                uniq.append(b)
            order.append(i)
        inputs = {f"{i}.{k}": v for i, b in enumerate(uniq) for k, v in b._asdict().items()}

        def body(state, inputs, params):
            shared = [ReadBatch(**{k: inputs[f"{i}.{k}"] for k in ReadBatch._fields})
                      for i in range(len(uniq))]
            return self._step_local(state, [shared[i] for i in order], params)

        return self.graphs.run("step", state, inputs, params, body,
                               self.win_cap(params, self.halo), tag=tuple(order))

    def eager(self, path: str, state, batch, params: StepParams):
        """The step body run eagerly, outside the graph cache (``path``:
        "step"): the reference a replay is held against and timed beside."""
        if path != "step":
            raise NotImplementedError("the sharded step runs the classic flow only")
        batches = batch if isinstance(batch, list) else self.put_batch(batch)
        return self._step_local(state, batches, params)

    # --------------------------------------------------------------- body ---

    def _run(self, fn, i: int, *args, **kw):
        if self.probe is not None:
            self.probe(fn, i, args, kw)
        return fn(*args, **kw)

    @torch.no_grad()
    def _step_local(self, state: GenomeState, batches: list[ReadBatch], params: StepParams):
        """The step body over this process's shards. Mirrors the JAX
        package's ShardedRunsEngine._step_local stage by stage; each
        collective cites the line of mesh.py it reproduces."""
        cfg = self.config
        comm = self.mesh.comm
        S = self.shards
        idx = range(len(S))
        halo, Gdl = self.halo, self.Gdl

        # -- 1. coverage (mesh.py:234-273) ------------------------------------
        changed = []
        for i in idx:
            b = batches[i]
            rows = gops.CovRows(b.mr_bc, b.mr_g, b.mr_len, b.ex_bcsym, b.ex_g)
            changed.append(self._run(gops.shard_coverage, i, state.coverage[i], S[i].c["seq"],
                                     rows, S[i].b0, S[i].g0))
        if self.Sb > 1:  # "changed" is per site over all barcodes (mesh.py:273)
            flags = [c.to(torch.int32) for c in changed]
            comm.sum(flags, "b")
            changed = [f > 0 for f in flags]

        # -- 2. scores (mesh.py:278-285) --------------------------------------
        scores, covsum = [], []
        for i in idx:
            s, c = self._run(site_scores, i, coverage=state.coverage[i], seq=S[i].c["seq"],
                             site_valid=S[i].c["site_valid"], tables=S[i].tables,
                             freeze_cov=cfg.freeze_cov, tiny=self.tiny)
            scores.append(s)
            covsum.append(c)

        # -- 3. dropout, buckets, fhat (mesh.py:287-336) ----------------------
        aux = [torch.zeros(4, dtype=self.dtype, device=sh.device) for sh in S]
        rkw = [self._row_kw(state, i, scores[i], covsum[i], changed[i], aux[i], params,
                            batches[i]) for i in idx]
        rws = [gops.row_workspace(scores[i], S[i].c["contig_denom"], self.NW_pad,
                                  state.read_starts[i], low=self.Sb > 1) for i in idx]
        for i in idx:
            self._run(gops.shard_rows, i, "sums", rws[i], **rkw[i])
        comm.sum([w["per_contig"] for w in rws], "both")   # mesh.py:291
        comm.sum([w["total"] for w in rws], "both")        # mesh.py:414
        comm.sum([w["winsums"] for w in rws], "g")         # mesh.py:315
        for i in idx:
            self._run(gops.shard_rows, i, "tables", rws[i], **rkw[i])
        if self.Sb > 1:
            on = [a[:1].to(torch.int32) for a in aux]
            comm.sum(on, "b")                               # mesh.py:321
            for a, o in zip(aux, on):
                a[0] = (o[0] > 0).float()
            for i in idx:
                self._run(gops.shard_rows, i, "low", rws[i], **rkw[i])
            low = [w["low"].to(torch.int32) for w in rws]
            comm.sum(low, "b")                              # mesh.py:297
            for w, lo in zip(rws, low):
                w["low"].copy_(lo > 0)
        for i in idx:
            self._run(gops.shard_rows, i, "apply", rws[i], **rkw[i])

        # -- 4. benefit, threshold, strategy (mesh.py:338-407) ----------------
        bkw = [self._benefit_kw(state, i, rws[i], aux[i], params) for i in idx]
        bws = [gops.benefit_workspace(rws[i]["scores_ds"]) for i in idx]
        for i in idx:
            self._run(gops.shard_benefit, i, "scan", bws[i], **bkw[i])
        tiles = comm.gather_g([w["tile_sums"] for w in bws])  # mesh.py:343
        for i in idx:
            t = tiles[i]                                      # [Sg, nb_l, n_tiles]
            bws[i]["tiles_g"] = t.permute(1, 0, 2).reshape(t.shape[1], -1).contiguous()
            bws[i]["tile0"] = S[i].g * t.shape[2]
            self._run(gops.shard_benefit, i, "prefix", bws[i], **bkw[i])
        left = comm.shift_g([w["cs"][:, Gdl - halo: Gdl].contiguous() for w in bws], 1)
        right = comm.shift_g([w["cs"][:, 1: halo + 1].contiguous() for w in bws], -1)
        for i in idx:                                         # mesh.py:350-354
            bws[i]["ext"] = torch.cat([left[i], bws[i]["cs"], right[i]], dim=1)
            self._run(gops.shard_benefit, i, "windows", bws[i], **bkw[i])
        comm.max([w["norm"] for w in bws], "both")            # mesh.py:392
        nz = [w["any_nz"] for w in bws]
        comm.max(nz, "both")                                  # mesh.py:393
        for i in idx:
            self._run(gops.shard_benefit, i, "bins", bws[i], **bkw[i])
        counts = [w["counts"].long() for w in bws]
        comm.sum(counts, "both")                              # mesh.py:395
        comm.sum([w["fsum"] for w in bws], "both")            # mesh.py:396
        comm.sum([w["ubar0"] for w in bws], "both")           # mesh.py:397-399
        for i in idx:
            bws[i]["counts"].copy_(counts[i])
            self._run(gops.shard_benefit, i, "threshold", bws[i], **bkw[i])
        # the post-dropout, post-sticky-zero scores (mesh.py:303, :425)
        gathered = self.gather_scores(scores) if cfg.debug_aux else None
        return state, StepAux(vec=aux[0], threshold=bws[0]["threshold"], scores=gathered)

    def _row_kw(self, state, i, scores, covsum, changed, aux, params, batch) -> dict:
        """Arguments of shard i's row phases (RunsEngine.row_args on the
        shard's blocks)."""
        c = self.shards[i].c
        cfg = self.config
        return dict(
            scores=scores, covsum=covsum, changed=changed, zeroed=state.zeroed[i],
            bucket_on=state.bucket_on[i], read_starts=state.read_starts[i], aux=aux,
            rs_row=batch.rs_row, rs_strand=batch.rs_strand, rs_w=batch.rs_w, rs_read=None,
            bits=None, site_valid=c["site_valid"], contig_id_ds=c["contig_id_ds"],
            contig_denom=c["contig_denom"], win_id_ds=c["win_id_ds"], n_win_pad=self.NW_pad,
            bucket_src=c["bucket_src"], bucket_valid=c["bucket_valid"], fhat_idx=c["fhat_idx"],
            fhat_valid=c["fhat_valid"], fhat_rows=c["fhat_rows"], n_fhat=self.layout.n_fhat,
            n_real_sites=self.n_real_sites, freeze_cov=cfg.freeze_cov,
            dropout_mod=cfg.dropout_mod, dropout_min_mean=cfg.dropout_min_mean,
            bucket_threshold=params.bucket_threshold.to(c["seq"].device),
            fhat_alpha=cfg.fhat_alpha,
            fhat_p0=cfg.fhat_p0, on_target=cfg.on_target,
        )

    def _benefit_kw(self, state, i, rws, aux, params) -> dict:
        """Arguments of shard i's benefit phases (RunsEngine.benefit_args on
        the shard's blocks; windows clipped to the halo on the device,
        mesh.py:358-361)."""
        sh, cfg = self.shards[i], self.config
        return dict(
            scores_ds=rws["scores_ds"], seg_start=sh.c["seg_start"], seg_end=sh.c["seg_end"],
            fhat_exp=rws["fhat_exp"], bucket_on=state.bucket_on[i],
            bucket_idx=sh.c["bucket_idx"], strat_valid=sh.c["strat_valid"],
            strat=state.strat[i], aux=aux, mu_ds=cfg.mu // DS,
            approx_ccl=params.approx_ccl.to(sh.device), time_cost=params.time_cost.to(sh.device),
            win_clamp=self.halo,
            win_cap=self.win_cap(params, self.halo), row0=sh.row0, halo=self.halo,
            reference_quirks=cfg.reference_quirks,
        )


# ------------------------------------------------------------------ demo ---

def demo_sharded_step(n_devices: int = 8, barcode_shards: int = 1, seed: int = 0,
                      n_steps: int = 3, *, mesh: Mesh | None = None,
                      config: RunsConfig = RunsConfig()):
    """Build a small multi-contig genome, shard it over the mesh, run the
    full update step ``n_steps`` times: the twin of the JAX package's demo,
    on the same genome and batch (made with numpy from ``seed``). Used by
    the dry run and as a living example.

    The mesh is ``mesh`` when given, else an in-process mesh of
    ``n_devices`` shards on the CPU; ``config`` is the engine's. The batch carries
    enough coverage (~6x mean per step over c1, 5% mismatches) that by the
    last step bucket switches flip on and the threshold scan produces a
    real mask."""
    from ..io.coo_native import pad_split, split_runs
    from ..models.convert import batch_from_numpy

    if mesh is None:
        mesh = make_mesh(["cpu"] * n_devices, barcode_shards=barcode_shards)
    rng = np.random.default_rng(seed)
    nb = max(2, mesh.Sb) if mesh.Sb > 1 else 1
    contigs = {
        "c1": rng.integers(0, 4, 150_000).astype(np.uint8),
        "c2": rng.integers(0, 4, 120_000).astype(np.uint8),
    }
    layout = build_layout(contigs, n_barcodes=nb, align_chunks=mesh.Sg)
    eng = ShardedRunsEngine(layout, mesh, config=config)
    state = eng.init_state()

    n_runs, run_len = 768, 2048
    rstart = rng.integers(0, 148_000 - run_len, n_runs).astype(np.int32)
    pos = np.concatenate([np.arange(s0, s0 + run_len) for s0 in rstart])
    sym = layout.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 4, int(flip.sum()))
    split = split_runs(
        layout, sym,
        np.full(pos.shape[0], 40, np.int8), rstart.astype(np.int64),
        np.full(n_runs, run_len, np.int32),
        rng.integers(0, nb, n_runs).astype(np.int32),
    )
    batch_np = dict(
        pad_split(split),
        rs_row=rng.integers(0, layout.n_fhat, 512).astype(np.int32),
        rs_strand=rng.integers(0, 2, 512).astype(np.int32),
        rs_w=np.ones(512, np.float32),
    )
    batch = eng.put_batch(batch_from_numpy(batch_np, "cpu"))
    params = eng.make_params(
        np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400]), 5300.0
    )
    aux = None
    for _ in range(n_steps):
        state, aux = eng.step(state, batch, params)
    return eng, state, aux

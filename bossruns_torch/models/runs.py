"""BOSS-RUNS update engine on PyTorch: one state transition per read batch.

The counterpart of ``bossruns_tpu.models.runs``:

    (GenomeState, ReadBatch, StepParams) -> (GenomeState, StepAux)

over the same dense, padded genome-axis layout (bossruns_tpu/models/
layout.py). The step is four stages, each a hand-written CUDA kernel for
CUDA tensors and a plain PyTorch version for CPU tensors:

  1. coverage scatter + saturating add + changed flags   H1 coverage_update
  2. per-site scores with the freeze and site masks       H2 site_scores
  3. dropout, sticky zeros, buckets, read-start posterior  H3 row_stage
  4. S_mu + CCL benefit, exponent-binned threshold, gated  H4 benefit_strategy
     strategy write

The state is updated IN PLACE, where the JAX engine donated it
(``donate_argnums=(0,)``): ``step`` returns the same tensors it was given.
The engine keeps H2's output, the per-site scores (after the row stage's
zeros) and coverage sums, in buffers of its own between steps, and H2
rescores only the tiles of 4096 sites that H1 flagged, as the upstream
recomputes only changed sites (``Scoring.update_scores``). That holds
while the state is the one the engine last stepped, untouched since: the
same coverage and zeroed tensors at the same ``_version`` (a restore's
``copy_``, a new state or another engine's step makes the next step
rescore every site; the counters ``scores.full`` and ``scores.tiled``
count the two kinds). Every step bumps the two tensors' ``_version``
itself, since the kernels' writes do not; so a state may be written only
through torch ops and engines' steps, or a writer that bypasses both (a
DLPack consumer, a kernel of its own) bumps it too
(``torch.autograd.graph.increment_version``).
csrc/scores.cu gives the argument that the result is the dense one, bit
for bit. H1 uses the kept coverage sums as its match scratch.
A host batch ships as the JAX package's uint32 wire buffer
(``pack_wire``/``pack_gated``, byte for byte the same buffer and spec),
packed into a pinned staging buffer and landed in the tier's static device
wire by one async host-to-device copy, and is viewed field by field on the
device (``unpack_wire``): ``step_from_numpy``.

On the card each path (``step``, ``step_from_numpy``, ``step_gated``) runs
as the JAX engine's jitted step does: the parameters are device tensors
(StepParams), and each batch-shape tier has one captured CUDA graph
(models/graphs.py), replayed from its second occurrence on; the first
runs eagerly, as the warm-up. ``engine.graphs`` counts replays and eager
steps per path. CPU tensors run the plain versions eagerly. Left out,
because they existed for the TPU: genome constants passed as jit
arguments (an HLO literal-size workaround) and the ``score_block`` scan
(an HBM cap that a per-site kernel does not need).

The engine options of the JAX package run here too: ``RunsConfig.dtype``
(the per-site scores, read starts and aux: "float32", "float64" or
"float16", whose rounding follows the JAX engine's: read starts that
stop at 2048, coverage sums rounded per site and inf above 65,519),
``RunsConfig.benefit_dtype`` (the decision path: "float64" or "float32")
and ``RunsConfig.fhat_alpha`` (any prior; alpha == 1 keeps the closed
form). Each dtype pair has its own kernel entry points; torch always has
f64, so the JAX package's fallback from f64 to f32 without x64 has no
counterpart, and nothing narrows silently.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.model import ObservationModel, make_model

from ..device import as_device
from ..utils import spans
from ..ops.genome_ops import (
    NP_FLOAT, CovRows, benefit_strategy, coverage_update_tiled, default_dtypes, row_stage,
)
from ..ops.scores import ScoreTables, site_scores
from .layout import BUCKET, DS, GenomeLayout


class GenomeState(NamedTuple):
    coverage: torch.Tensor     # [NB, 5, G_pad] uint16, saturating at 65535
    zeroed: torch.Tensor       # [NB, G_pad] bool — sticky dropout zeros
    bucket_on: torch.Tensor    # [NB, NBk_pad] bool — sticky activation switches
    read_starts: torch.Tensor  # [Wf_pad, 2] score dtype — accumulated start counts
    strat: torch.Tensor        # [NB, Gd_pad, 2] bool — current strategy


class ReadBatch(NamedTuple):
    """Match-run + explicit-observation batch (host-built, see
    bossruns_tpu.models.runs.ReadBatch). Padding: mr_len 0, ex_g EX_PAD."""

    mr_bc: torch.Tensor      # [RM] uint8
    mr_g: torch.Tensor       # [RM] uint32
    mr_len: torch.Tensor     # [RM] uint16
    ex_bcsym: torch.Tensor   # [ME] uint16 bc*5 + sym
    ex_g: torch.Tensor       # [ME] uint32
    rs_row: torch.Tensor     # [Rs] int32 global fhat window row
    rs_strand: torch.Tensor  # [Rs] int32 0=fwd 1=rev
    rs_w: torch.Tensor       # [Rs] f32


class StepParams(NamedTuple):
    """The step's parameters on the engine's device, as the JAX engine
    traces its StepParams (bossruns_tpu/models/runs.py:104-107): the three
    are views of one int32[12] ``block``, so a captured step takes a new
    batch's parameters with one copy. ``win_bucket`` (host) is the power of
    two at or above the widest CCL window before the engine's clamp (ds
    rows): the bound H4's shared memory is sized for, part of a graph's key."""

    approx_ccl: torch.Tensor        # [10] int32 full-res CCL pieces
    time_cost: torch.Tensor         # 0-d f32: lambda - mu - rho
    bucket_threshold: torch.Tensor  # 0-d f32
    block: torch.Tensor             # [12] int32: the three above
    win_bucket: int


def params_view(block: torch.Tensor, win_bucket: int) -> StepParams:
    """StepParams whose tensors are views of ``block`` (int32 [12])."""
    f32 = block[10:].view(torch.float32)
    return StepParams(approx_ccl=block[:10], time_cost=f32[0], bucket_threshold=f32[1],
                      block=block, win_bucket=win_bucket)


class StepAux(NamedTuple):
    vec: torch.Tensor        # [4] score dtype: any_on, updated, threshold, mean coverage
    threshold: torch.Tensor  # 0-d accept threshold (benefit units), decision dtype
    scores: torch.Tensor | None = None  # [NB, G] post-mask scores (debug_aux only)

    @property
    def any_on(self) -> torch.Tensor:
        return self.vec[0] > 0

    @property
    def updated(self) -> torch.Tensor:
        return self.vec[1] > 0

    @property
    def mean_coverage(self) -> torch.Tensor:
        return self.vec[3]


class AuxHost(NamedTuple):
    """Host copy of StepAux, fetched with one device->host copy (pull_aux)."""

    any_on: bool
    updated: bool
    threshold: float
    mean_coverage: float


@dataclasses.dataclass(frozen=True)
class RunsConfig:
    mu: int = 400
    qt: int = 0                   # quality threshold (sequences.py:659)
    freeze_cov: int = 30          # sequences.py:419
    dropout_mod: int = 8          # reference.py:166
    dropout_min_mean: float = 5.0  # reference.py:158
    bucket_threshold: float = 5.0  # config.py:51
    fhat_alpha: float = 1.0
    fhat_p0: float = 0.1
    on_target: float = 1.0
    # per-site scores, read starts and aux: "float32", "float64" or "float16"
    dtype: str = "float32"
    # decision-path precision: "float64" (production) or "float32"
    benefit_dtype: str = "float64"
    # static clamp (ds rows) on the CCL benefit windows
    ccl_clamp_ds: int = 4096
    # return the post-mask score array in StepAux (parity tests/debugging)
    debug_aux: bool = False
    # reference-quirk Q1: the threshold scan's ubar0 from benefit, not S_mu
    reference_quirks: bool = False


#: the dtypes the engine runs, by RunsConfig name: the score dtype
#: (``dtype``) takes all three, the decision dtype (``benefit_dtype``)
#: float32 and float64
DTYPES = {"float16": torch.float16, "float32": torch.float32, "float64": torch.float64}
DECISION_DTYPES = ("float32", "float64")


def engine_dtype(name: str, what: str) -> torch.dtype:
    """torch dtype of a RunsConfig dtype name (``what``: "dtype" or
    "benefit_dtype"); ValueError for any other."""
    names = tuple(DTYPES) if what == "dtype" else DECISION_DTYPES
    if name in names:
        return DTYPES[name]
    if name == "bfloat16":
        raise ValueError(f"{what}={name!r}: the JAX engine cannot run it either (np.finfo "
                         f"raises on it); the port runs {', '.join(names)}")
    raise ValueError(f"{what}={name!r}: the port runs {', '.join(names)}")


def normalize_state(state: GenomeState, read_starts_dtype=torch.float32) -> GenomeState:
    """Cast a restored state to the current dtypes (legacy checkpoints
    stored coverage as int32; read starts follow the engine's score dtype,
    so a state written at one dtype loads at another)."""
    if state.coverage.dtype != torch.uint16:
        cov = torch.clamp(state.coverage.long(), 0, 65535)
        cov = (cov - 65536 * (cov > 32767)).to(torch.int16).view(torch.uint16)
        state = state._replace(coverage=cov)
    if state.read_starts.dtype != read_starts_dtype:
        state = state._replace(read_starts=state.read_starts.to(read_starts_dtype))
    return state


#: numpy dtype -> torch dtype of the wire's fields
_TORCH_OF = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
             np.dtype(np.uint32): torch.uint32, np.dtype(np.int32): torch.int32,
             np.dtype(np.float32): torch.float32}


class RunsEngine(nn.Module):
    """Genome-sized constants (registered buffers) and the update step.

    The engine keeps the scores of the state it stepped last; a state
    written outside torch ops and engines' steps must have its coverage's
    and zeroed's ``_version`` bumped by its writer (module docstring)."""

    #: step_from_numpy (one-copy wire upload) is valid on this engine
    wire_capable = True
    #: the strategy's copy to pinned host memory after a step
    #: (``strat_to_host_async``); None on the CPU and on the sharded engine
    _strat_pull = None
    #: (scores, covsum) [NB, G_pad] kept between steps, H2's output buffers;
    #: None on the sharded engine
    _kept = None

    def __init__(self, layout: GenomeLayout, model: ObservationModel | None = None,
                 config: RunsConfig = RunsConfig(), *, device):
        super().__init__()
        consts = self._setup(layout, model, config)
        dev = as_device(device)
        self.device = dev
        self.tables = ScoreTables(self.model, self.dtype, device=dev)
        for name, (a, dtype) in consts.items():
            self.register_buffer(name, torch.as_tensor(np.asarray(a), dtype=dtype).to(dev))
        shape = (self.nb, layout.G_pad)
        self._kept = (torch.zeros(shape, dtype=self.dtype, device=dev),
                      torch.zeros(shape, dtype=torch.int32, device=dev))
        # H2's rescore-all flag (int32 [1], read on the device), its host
        # copy, and the state the kept values belong to (``_kept_valid``)
        self._full = torch.ones(1, dtype=torch.int32, device=dev)
        self._full_host = True
        self._kept_for = None
        self.graphs, self._staging = None, None
        if dev.type == "cuda":
            from ..utils.staging import PinnedCopy, PinnedStaging
            from .graphs import GraphCache

            self.graphs, self._staging = GraphCache(dev), PinnedStaging()
            self._strat_pull = PinnedCopy()

    def _setup(self, layout: GenomeLayout, model: ObservationModel | None,
               config: RunsConfig) -> dict:
        """Host attributes of the engine; returns the genome constants as
        {name: (numpy array, torch dtype)}, which the engine places."""
        self.dtype = engine_dtype(config.dtype, "dtype")
        self.benefit_dtype = engine_dtype(config.benefit_dtype, "benefit_dtype")
        self.layout = layout
        self.config = config
        self.model = model if model is not None else make_model(ploidy=1)
        np_s, np_d = (NP_FLOAT[t] for t in (self.dtype, self.benefit_dtype))
        self.tiny = float(np.finfo(np_s).tiny)
        lay = layout
        self.nb = lay.n_barcodes
        consts = {}

        def buf(name, a, dtype):
            consts[name] = (a, dtype)

        buf("seq", lay.seq_int.astype(np.int8), torch.int8)
        buf("site_valid", lay.site_valid(), torch.bool)
        buf("contig_id_ds", np.where(lay.contig_id_ds < 0, lay.n_contigs, lay.contig_id_ds),
            torch.int32)
        buf("seg_start", lay.ds_seg_start, torch.int32)
        buf("seg_end", lay.ds_seg_end, torch.int32)
        buf("strat_valid", lay.strat_row_valid, torch.bool)
        buf("fhat_idx", lay.fhat_idx, torch.int32)
        buf("bucket_idx", lay.bucket_idx, torch.int32)
        buf("bucket_valid", np.arange(lay.NBk_pad) < lay.n_buckets, torch.bool)
        buf("fhat_valid", np.arange(lay.Wf_pad) < lay.n_fhat, torch.bool)
        # bucket source windows: every bucket reads the mean of one full
        # 200-ds-row window; ds rows are summed INTO windows (integer-exact)
        win_rows = BUCKET // DS
        uniq_lo = np.unique(lay.bucket_lo_ds[lay.bucket_lo_ds >= 0])
        self.n_win = int(uniq_lo.shape[0])
        self.NW_pad = max(8, -(-self.n_win // 8) * 8)
        win_id = np.full(lay.Gd_pad, -1, np.int32)
        if self.n_win:
            rows_f = (uniq_lo[:, None] + np.arange(win_rows)[None, :]).ravel()
            win_id[rows_f] = np.repeat(np.arange(self.n_win, dtype=np.int32), win_rows)
        src = np.searchsorted(uniq_lo, lay.bucket_lo_ds).astype(np.int32)
        buf("win_id_ds", win_id, torch.int32)
        buf("bucket_src", np.where(lay.bucket_lo_ds >= 0, src, -1), torch.int32)
        # rows per fhat window: closes the fhat normaliser over [Wf]
        fhat_rows = np.bincount(lay.fhat_idx[lay.fhat_idx >= 0], minlength=lay.Wf_pad)
        buf("fhat_rows", fhat_rows.astype(np_d), self.benefit_dtype)
        # per-contig site counts (+ a trailing pseudo-contig for padding),
        # stored in the score dtype as the reference engine stores them, and
        # read in the decision dtype
        with np.errstate(over="ignore"):  # f16: inf from 65,520 sites, as in the JAX engine
            denom = np.append(lay.lengths * lay.n_barcodes, 1).astype(np_s)
        buf("contig_denom", denom.astype(np_d), self.benefit_dtype)
        self.n_real_sites = float(lay.lengths.sum())
        return consts

    # ------------------------------------------------------- wire format ----
    # A host batch as ONE uint32 buffer: each field's bytes in field order,
    # padded to 4 bytes (bossruns_tpu/models/runs.py:319-405, copied, numpy),
    # and a static spec of (name, elements) per field. On the device the
    # fields are views of the buffer (as JAX's bitcasts), in the dtypes the
    # kernels take: every field starts 4-byte aligned, and no kernel needs
    # more of a batch array.

    _WIRE_FIELDS = (
        ("mr_bc", np.uint8), ("mr_g", np.uint32), ("mr_len", np.uint16),
        ("ex_bcsym", np.uint16), ("ex_g", np.uint32), ("rs_row", np.int32),
        ("rs_strand", np.int32), ("rs_w", np.float32),
    )

    #: gated-batch wire: both candidate coverage sets (f_* full records,
    #: t_* mu-truncated records) with per-row read indices, and the full
    #: set's read-start rows
    _GATED_FIELDS = (
        ("f_mr_bc", np.uint8), ("f_mr_g", np.uint32), ("f_mr_len", np.uint16),
        ("f_mr_read", np.uint32),
        ("f_ex_bcsym", np.uint16), ("f_ex_g", np.uint32), ("f_ex_read", np.uint32),
        ("t_mr_bc", np.uint8), ("t_mr_g", np.uint32), ("t_mr_len", np.uint16),
        ("t_mr_read", np.uint32),
        ("t_ex_bcsym", np.uint16), ("t_ex_g", np.uint32), ("t_ex_read", np.uint32),
        ("rs_row", np.int32), ("rs_strand", np.int32), ("rs_read", np.int32),
    )

    @staticmethod
    def _pack_fields(get, fields, out=None):
        """Each field's bytes written straight into one uint32 buffer:
        ``out(n_words)`` (a staging buffer), or a new array."""
        with spans.span("engine.pack"):
            arrs = [np.ascontiguousarray(get(name), dtype=dt) for name, dt in fields]
            words = [(a.nbytes + 3) // 4 for a in arrs]
            wire = np.empty(sum(words), np.uint32) if out is None else out(sum(words))
            raw = wire.view(np.uint8)
            off = 0
            for a, w in zip(arrs, words):
                nb = a.nbytes
                raw[off: off + nb] = a.reshape(-1).view(np.uint8)
                raw[off + nb: off + 4 * w] = 0
                off += 4 * w
        return wire, tuple((name, int(a.shape[0])) for (name, _), a in zip(fields, arrs))

    @classmethod
    def pack_wire(cls, batch: dict | ReadBatch, out=None):
        """dict/ReadBatch of numpy arrays -> (wire uint32[W], spec), spec a
        tuple of (name, n_elems) per field. ``out``: a function of the word
        count that gives the buffer to write (``stage``), else a new array."""
        get = batch.__getitem__ if isinstance(batch, dict) else lambda f: getattr(batch, f)
        return cls._pack_fields(get, cls._WIRE_FIELDS, out)

    @classmethod
    def pack_gated(cls, d: dict, out=None):
        """dict of the _GATED_FIELDS arrays -> (wire uint32[W], spec);
        ``out`` as pack_wire's."""
        return cls._pack_fields(d.__getitem__, cls._GATED_FIELDS, out)

    def stage(self, n_words: int) -> np.ndarray:
        """A uint32 [n_words] host buffer to pack a wire into: on the card one
        of two pinned staging buffers, taken in turns and reused across
        batches (``upload_wire`` copies it asynchronously); on the CPU a new
        array."""
        if self._staging is None:
            return np.empty(n_words, np.uint32)
        return self._staging.take(n_words)

    @staticmethod
    def _unpack_fields(wire: torch.Tensor, spec, fields) -> dict[str, torch.Tensor]:
        """Views of the uint32 ``wire`` (on any device), one per field of
        ``spec``, in the field's dtype; field order and padding as
        ``_pack_fields``."""
        dts = dict(fields)
        raw = wire.view(torch.uint8)
        out, off = {}, 0
        for name, n in spec:
            dt = np.dtype(dts[name])
            nbytes = n * dt.itemsize
            out[name] = raw[off: off + nbytes].view(_TORCH_OF[dt])
            off += (nbytes + 3) // 4 * 4
        return out

    @staticmethod
    def unpack_wire(wire: torch.Tensor, spec) -> ReadBatch:
        """The ReadBatch that ``pack_wire`` packed, as views of ``wire``."""
        return ReadBatch(**RunsEngine._unpack_fields(wire, spec, RunsEngine._WIRE_FIELDS))

    @classmethod
    def unpack_gated(cls, wire: torch.Tensor, spec) -> dict[str, torch.Tensor]:
        """The dict that ``pack_gated`` packed, as views of ``wire`` (what
        ``step_gated`` takes)."""
        return cls._unpack_fields(wire, spec, cls._GATED_FIELDS)

    def upload_wire(self, wire: np.ndarray, spec=None) -> torch.Tensor:
        """A packed buffer on this engine's device. On the card ``wire``
        must have been packed into a ``stage`` buffer and ``spec`` given: one
        async copy on the current stream (the stream the step runs on) lands
        it in the tier's static device wire, the buffer the tier's captured
        step reads (valid until the next upload of the same spec). On the
        CPU, the buffer itself."""
        with spans.span("engine.upload"):
            if self.graphs is None:
                return torch.from_numpy(wire).to(self.device)
            if spec is None or self._staging is None:
                raise ValueError("upload_wire on the card takes a stage buffer and its spec")
            dst = self.graphs.wire(spec, wire.shape[0])
            if not self._staging.upload(wire, dst):
                raise ValueError("upload_wire: the wire was not packed into a stage buffer")
            return dst

    def step_from_numpy(self, state: GenomeState, batch_np: dict | ReadBatch,
                        params: StepParams):
        """One step from a host batch (numpy): packed into a staging buffer,
        uploaded in one copy and viewed as a ReadBatch; the same result as
        ``step`` on the same batch, bit for bit."""
        wire, spec = self.pack_wire(batch_np, out=self.stage)
        views = self.unpack_wire(self.upload_wire(wire, spec), spec)
        return self._through_graphs("step_from_numpy", state, views._asdict(), params, self._classic)

    # ------------------------------------------------------------- state ----

    def init_state(self) -> GenomeState:
        lay, dev = self.layout, self.device
        return GenomeState(
            coverage=torch.zeros((self.nb, 5, lay.G_pad), dtype=torch.uint16, device=dev),
            zeroed=torch.zeros((self.nb, lay.G_pad), dtype=torch.bool, device=dev),
            bucket_on=torch.zeros((self.nb, lay.NBk_pad), dtype=torch.bool, device=dev),
            read_starts=torch.zeros((lay.Wf_pad, 2), dtype=self.dtype, device=dev),
            strat=self.strat_valid[None, :, None].expand(self.nb, lay.Gd_pad, 2).contiguous(),
        )

    def state_from_numpy(self, d: dict, device=None) -> GenomeState:
        """State fields as NumPy (a checkpoint, or the JAX engine's state
        through np.asarray) -> this engine's state on ``device`` (default:
        the engine's)."""
        from .convert import state_from_numpy

        return state_from_numpy(d, self.device if device is None else device, self.dtype)

    def state_numpy(self, state: GenomeState) -> dict[str, np.ndarray]:
        """The state as a dict of NumPy arrays (a copy)."""
        from .convert import state_to_numpy

        return state_to_numpy(state)

    def make_params(self, approx_ccl, time_cost: float) -> StepParams:
        """StepParams on this engine's device (one host-to-device copy):
        approx_ccl as int32, time_cost and the config's bucket threshold
        rounded to f32, as the JAX engine's make_params."""
        with spans.span("engine.params"):
            ccl = np.asarray(approx_ccl).astype(np.int32)
            if ccl.shape != (10,):
                raise ValueError(f"approx_ccl: 10 CCL pieces, got shape {ccl.shape}")
            host = np.empty(12, np.int32)
            host[:10] = ccl
            host[10:] = np.array([time_cost, self.config.bucket_threshold],
                                 np.float32).view(np.int32)
            widest = max(max(int(c) // DS, 1) for c in ccl)
            return params_view(torch.from_numpy(host).to(self.device),
                               1 << (widest - 1).bit_length())

    def win_cap(self, params: StepParams, win_clamp: int) -> int:
        """The widest window (ds rows) H4's shared memory holds for these
        params under ``win_clamp``: mu_ds, or the params' power-of-two
        bucket clamped. Every window the device computes is within it."""
        return max(self.config.mu // DS, min(params.win_bucket, win_clamp))

    # ------------------------------------------------ stage arguments -------
    # Each returns the keyword arguments of one stage's wrapper, so a caller
    # can run a stage's kernel and its plain version on the same inputs.

    def coverage_args(self, state: GenomeState, full: CovRows, trunc: CovRows | None = None,
                      bits: torch.Tensor | None = None) -> dict:
        return dict(coverage=state.coverage, seq=self.seq, full=full, trunc=trunc, bits=bits)

    def score_args(self, state: GenomeState) -> dict:
        return dict(coverage=state.coverage, seq=self.seq, site_valid=self.site_valid,
                    tables=self.tables, freeze_cov=self.config.freeze_cov, tiny=self.tiny)

    def row_args(self, state: GenomeState, scores, covsum, changed, aux, params: StepParams,
                 rs_row, rs_strand, rs_w=None, rs_read=None, bits=None) -> dict:
        cfg = self.config
        return dict(
            scores=scores, covsum=covsum, changed=changed, zeroed=state.zeroed,
            bucket_on=state.bucket_on, read_starts=state.read_starts, aux=aux,
            rs_row=rs_row, rs_strand=rs_strand, rs_w=rs_w, rs_read=rs_read, bits=bits,
            site_valid=self.site_valid, contig_id_ds=self.contig_id_ds,
            contig_denom=self.contig_denom, win_id_ds=self.win_id_ds, n_win_pad=self.NW_pad,
            bucket_src=self.bucket_src, bucket_valid=self.bucket_valid,
            fhat_idx=self.fhat_idx, fhat_valid=self.fhat_valid, fhat_rows=self.fhat_rows,
            n_fhat=self.layout.n_fhat, n_real_sites=self.n_real_sites,
            freeze_cov=cfg.freeze_cov, dropout_mod=cfg.dropout_mod,
            dropout_min_mean=cfg.dropout_min_mean, bucket_threshold=params.bucket_threshold,
            fhat_alpha=cfg.fhat_alpha, fhat_p0=cfg.fhat_p0, on_target=cfg.on_target,
        )

    def benefit_args(self, state: GenomeState, scores_ds, fhat_exp, aux,
                     params: StepParams) -> dict:
        cfg = self.config
        return dict(
            scores_ds=scores_ds, seg_start=self.seg_start, seg_end=self.seg_end,
            fhat_exp=fhat_exp, bucket_on=state.bucket_on, bucket_idx=self.bucket_idx,
            strat_valid=self.strat_valid, strat=state.strat, aux=aux, mu_ds=cfg.mu // DS,
            approx_ccl=params.approx_ccl, time_cost=params.time_cost,
            win_clamp=cfg.ccl_clamp_ds, win_cap=self.win_cap(params, cfg.ccl_clamp_ds),
            reference_quirks=cfg.reference_quirks, tile_scan=self.tile_scan,
        )

    @property
    def tile_scan(self) -> bool:
        """Whether the plain benefit stage scans tile by tile (the kernel's
        and the sharded step's order): where the decision sums are not
        exact, that is, away from the default dtypes."""
        return not default_dtypes(self.dtype, self.benefit_dtype)

    # ------------------------------------------------------ kept scores ----
    # H2 rescores only the tiles H1 flagged, over the scores and coverage
    # sums this engine keeps between steps, when they belong to the state
    # being stepped (csrc/scores.cu: why that is exact); else every site.

    @staticmethod
    def _stamp(state: GenomeState) -> tuple:
        """Address and version of the state's coverage and zeroed: every
        in-place torch write bumps a tensor's ``_version`` (a restore's
        ``copy_``); the kernels' writes do not, so ``_end_step`` bumps it."""
        return tuple((t.data_ptr(), t._version) for t in (state.coverage, state.zeroed))

    def _kept_valid(self, state: GenomeState) -> bool:
        """Whether the kept values are those of ``state`` as it is: the same
        coverage and zeroed objects that this engine's last step left, at
        the same address and version."""
        kf = self._kept_for
        return (kf is not None and kf[0]() is state.coverage and kf[1]() is state.zeroed
                and kf[2] == self._stamp(state))

    def _begin_step(self, state) -> None:
        """Before a step's body, outside any graph: set H2's device flag to
        rescore every site unless the kept values are valid (one fill, only
        when the flag changes), and count the step's kind."""
        if self._kept is None:
            return
        full = not self._kept_valid(state)
        self._kept_for = None  # until the step has run
        if full != self._full_host:
            self._full.fill_(int(full))
            self._full_host = full
        spans.count("scores.full" if full else "scores.tiled", 1)

    def _end_step(self, state) -> None:
        """After a step: the kept values are now ``state``'s. The step's
        kernels wrote coverage and zeroed without a torch op: bump their
        versions, so that another engine's kept values for this state are
        no longer valid."""
        if self._kept is not None:
            torch.autograd.graph.increment_version((state.coverage, state.zeroed))
            self._kept_for = (weakref.ref(state.coverage), weakref.ref(state.zeroed),
                              self._stamp(state))

    # -------------------------------------------------------------- step ----

    def _through_graphs(self, path: str, state, inputs: dict, params: StepParams, body):
        """``body(state, inputs, params)``: through the graph cache on the
        card, eagerly on the CPU."""
        if self._strat_pull is not None:
            self._strat_pull.drop()  # the step rewrites the strategy
        self._begin_step(state)
        with spans.span("engine.launch") as sp:
            if self.graphs is None:
                sp.attr("mode", "eager")
                out = body(state, inputs, params)
            else:
                out = self.graphs.run(path, state, inputs, params, body,
                                      self.win_cap(params, self.config.ccl_clamp_ds))
                sp.attr("mode", self.graphs.last_mode)
        self._end_step(state)
        return out

    def eager(self, path: str, state, *args):
        """The body of ``path`` ("step", "step_from_numpy" or "step_gated",
        with that method's arguments) run eagerly, outside the graph cache:
        the reference a replay is held against and timed beside."""
        if self._strat_pull is not None:
            self._strat_pull.drop()  # the step rewrites the strategy
        if path == "step_from_numpy":
            batch_np, params = args
            wire, spec = self.pack_wire(batch_np)
            batch = self.unpack_wire(torch.from_numpy(wire).to(self.device), spec)
            body, inputs = self._classic, batch._asdict()
        elif path == "step":
            batch, params = args
            body, inputs = self._classic, batch._asdict()
        else:
            gated, bits, params = args
            body, inputs = self._gated, dict(gated, bits=bits)
        self._begin_step(state)
        out = body(state, inputs, params)
        self._end_step(state)
        return out

    def _classic(self, state: GenomeState, inputs: dict, params: StepParams):
        b = ReadBatch(**inputs)
        full = CovRows(b.mr_bc, b.mr_g, b.mr_len, b.ex_bcsym, b.ex_g)
        return self._step(state, full, None, None, params, b.rs_row, b.rs_strand, rs_w=b.rs_w)

    def _gated(self, state: GenomeState, inputs: dict, params: StepParams):
        g = inputs
        full = CovRows(g["f_mr_bc"], g["f_mr_g"], g["f_mr_len"], g["f_ex_bcsym"], g["f_ex_g"],
                       g["f_mr_read"], g["f_ex_read"])
        trunc = CovRows(g["t_mr_bc"], g["t_mr_g"], g["t_mr_len"], g["t_ex_bcsym"], g["t_ex_g"],
                        g["t_mr_read"], g["t_ex_read"])
        return self._step(state, full, trunc, g["bits"], params,
                          g["rs_row"], g["rs_strand"], rs_read=g["rs_read"])

    @torch.no_grad()
    def _step(self, state: GenomeState, full: CovRows, trunc, bits, params: StepParams,
              rs_row, rs_strand, rs_w=None, rs_read=None):
        changed, tiles = coverage_update_tiled(**self.coverage_args(state, full, trunc, bits),
                                               match=self._kept[1])
        scores, covsum = site_scores(**self.score_args(state), out=self._kept, tiles=tiles,
                                     full=self._full)
        aux = torch.zeros(4, dtype=self.dtype, device=self.device)
        scores_ds, fhat_exp = row_stage(**self.row_args(
            state, scores, covsum, changed, aux, params, rs_row, rs_strand, rs_w, rs_read, bits))
        _, _, threshold = benefit_strategy(**self.benefit_args(
            state, scores_ds, fhat_exp, aux, params))
        return state, StepAux(vec=aux, threshold=threshold,
                              scores=scores.clone() if self.config.debug_aux else None)

    def step(self, state: GenomeState, batch: ReadBatch, params: StepParams):
        """One update from a ReadBatch on this engine's device. Updates
        ``state`` in place and returns it with the step's StepAux (on the
        card, a replayed step's StepAux lives in the graph's output buffers
        until the next replay of its tier)."""
        return self._through_graphs("step", state, batch._asdict(), params, self._classic)

    def step_gated(self, state: GenomeState, gated: dict, bits: torch.Tensor,
                   params: StepParams):
        """One update from a gated batch and per-read decision bits (uint8).

        ``gated`` holds device tensors named as ``_GATED_FIELDS`` (a dict
        of tensors, or ``unpack_gated``'s views of one uploaded wire): both candidate coverage sets, f_* (full
        records) and t_* (mu-truncated records), each with mr_bc, mr_g,
        mr_len, mr_read, ex_bcsym, ex_g, ex_read; plus rs_row, rs_strand and
        rs_read for the full set. A full-record row survives iff its read
        is accepted, a truncated-record row iff it is rejected, so the
        result is bit-identical to packing only the selected rows (the
        classic flow). Updates ``state`` in place."""
        return self._through_graphs("step_gated", state, dict(gated, bits=bits), params, self._gated)

    # ----------------------------------------------------------- host side --

    @staticmethod
    def pull_aux(aux: StepAux) -> AuxHost:
        """All step scalars in ONE device->host copy (waits for the step)."""
        with spans.span("engine.pull_aux"):
            v = aux.vec.cpu().tolist()
        spans.count("bytes.d2h", aux.vec.nbytes)
        return AuxHost(bool(v[0]), bool(v[1]), float(v[2]), float(v[3]))

    def strat_to_host_async(self, state: GenomeState) -> None:
        """Start the strategy's copy into pinned host memory behind the step
        on the current stream, as the JAX sims call
        ``state.strat.copy_to_host_async()`` before ``pull_aux``; the next
        ``strat_dict`` of this state waits on its event instead of pulling.
        Nothing to do on the CPU."""
        if self._strat_pull is not None:
            self._strat_pull.start(state.strat)

    def strat_dict(self, state: GenomeState) -> dict[str, np.ndarray]:
        """Per-contig strategy arrays in the reference npz convention:
        shape (length//100, 2, n_barcodes) bool; rejected contigs get a
        single-False array (reference.py:109-118). Takes the copy
        ``strat_to_host_async`` started, if one of this state's strategy
        is pending, else pulls it."""
        with spans.span("mask.pull"):
            strat = None if self._strat_pull is None else self._strat_pull.take(state.strat)
            if strat is None:
                strat = state.strat.cpu().numpy()  # [NB, Gd, 2]
        spans.count("bytes.d2h", strat.nbytes)
        out = {}
        with spans.span("mask.split"):
            for c, name in enumerate(self.layout.names):
                r0, n = self.layout.strat_rows(c)
                # always a copy: on the CPU ``strat`` views the state, which the
                # next step updates in place (with one barcode the transposed
                # slice is already contiguous, and ascontiguousarray kept the view)
                out[name] = np.array(strat[:, r0 : r0 + n, :].transpose(1, 2, 0), order="C")
            for name in self.layout.rejected_names:
                out[name] = np.zeros(1, dtype=bool)
        return out

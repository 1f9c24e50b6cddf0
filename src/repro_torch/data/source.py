"""Chunk sources — out-of-core scans; port of ``repro/data/source.py``
(``ColumnSpec``/``ChunkSpec`` l.83-124, ``ChunkSource`` l.125-240,
``InMemorySource`` l.251-278, ``NpyMmapSource`` l.280-332,
``EncodedSource`` l.334-463, ``ParquetSource`` l.465-612,
``PartitionLostError`` l.65-80,
``RepartitionedSource`` l.614-701, ``as_source``/``repartition``
l.704-722).

The paper estimates over tables far larger than any device holds.  A
:class:`ChunkSource` decouples the scan from residency: it yields
round-slices ``[P, hi-lo, L]`` of its columns (incl. ``_mask``) and
per-chunk live counts, and a session over a streaming source
(``repro_torch.session``) pulls one slice per round through a
double-buffered host→device prefetcher, so device memory stays O(slice)
while finals, snapshots and bounds stay bitwise those of the resident run.

  * :class:`InMemorySource` — resident ``[P, C, L]`` tensors; what a plain
    shards dict becomes (:func:`as_source`).  Sessions keep their
    whole-scan program for it.
  * :class:`NpyMmapSource` — one memory-mapped ``<column>.npy`` per
    column, the reference's layout: either package reads what the other
    wrote.
  * :class:`EncodedSource` — dictionary-coded and bit-packed columns
    (``data/encodings.py``) stored physical, with the reference's
    ``encodings.json``; it presents the plain logical ``spec``, ships the
    physical bytes, and the scan decodes them on the device.
  * :class:`ParquetSource` — one ``part-*.parquet`` file of live rows a
    partition, read by covering row groups with column projection and a
    bounded read-ahead; needs the optional ``pyarrow``.
  * :class:`RepartitionedSource` — a P'-way view of a P-way source
    (elastic resume): over a resident source its round-slices are
    gathered on the device the data lives on (``device_slices``), over a
    streaming one on the host.
  * :class:`PartitionRangeSource` — partitions [lo, hi) of a source, one
    rank's share under ``repro_torch.sharded``: reads touch those
    partitions alone (every source's ``*_parts`` methods), and the
    fingerprint is the whole layout's.

Streaming sources return host NumPy arrays from :meth:`ChunkSource.slice_cols`
(the reference's API) and can copy a slice straight into caller buffers
(:meth:`ChunkSource.read_into`, which the CUDA prefetcher points at pinned
staging memory).  Every source publishes the reference's content
:meth:`ChunkSource.fingerprint` — sha256 over ``repr(spec)``, the per-chunk
``_mask`` sums and strided samples of every column's logical values — equal
to the reference's on the same rows.  A source whose storage dies
mid-scan raises :class:`PartitionLostError`.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.data import encodings as ENC

# Bound on host bytes touched per fingerprint/mask-sum pass (the reference's).
_SAMPLE_CHUNKS = 8
_SAMPLE_ELEMS = 256


class PartitionLostError(RuntimeError):
    """A partition's storage or device vanished mid-scan.

    Raised by a source (and surfaced through the session's prefetcher)
    when a slice read touches a partition that no longer exists.  A
    session with a ``repro_torch.session.FaultPolicy`` records the failure
    round and retries the read; the source then serves the dead
    partitions' columns and masks zeroed — the data is gone, not stale.
    Without a policy the error propagates: losing data is not silently
    survivable by default.
    """

    def __init__(self, partitions):
        self.partitions = tuple(sorted(int(p) for p in partitions))
        super().__init__(f"partitions lost mid-scan: {list(self.partitions)}")


class ColumnSpec(NamedTuple):
    name: str
    dtype: str  # NumPy's dtype name, e.g. "float32"
    trailing: Tuple[int, ...] = ()  # dims after [P, C, L] (usually none)
    # logical elements per stored element: 1 for plain columns, the
    # per-word lane count for bit-packed physical columns
    lanes: int = 1


class ChunkSpec(NamedTuple):
    """Static shape contract of a source: [P, C, L] plus column table.
    ``repr`` feeds the fingerprint and prints as the reference's."""

    P: int
    C: int
    L: int
    columns: Tuple[ColumnSpec, ...]  # sorted by name; includes "_mask"

    def meta(self) -> dict:
        """JSON-able form for checkpoint envelopes (the reference's)."""
        return {"P": self.P, "C": self.C, "L": self.L,
                "columns": [[c.name, c.dtype, list(c.trailing)]
                            for c in self.columns]}

    def slice_like(self, width: int) -> dict:
        """{name: (shape, dtype name)} of one [P, width, L] slice."""
        return {c.name: ((self.P, width, self.L // c.lanes, *c.trailing), c.dtype)
                for c in self.columns}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def as_tensor(x) -> torch.Tensor:
    """A slice column as a tensor: tensors pass through, host arrays are
    wrapped without a copy unless they are read-only (a mmap view)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _mask_sums(read_mask, P: int, C: int) -> np.ndarray:
    """Per-(partition, chunk) live counts, float64 [P, C], from
    ``read_mask(lo, hi)`` (the [P, hi-lo, L] mask) in 512-chunk steps, so
    at most a slice of the data is read at a time."""
    out = np.zeros((P, C), np.float64)
    step = _SAMPLE_CHUNKS * 64
    for lo in range(0, C, step):
        hi = min(C, lo + step)
        out[:, lo:hi] = _numpy(read_mask(lo, hi)).sum(axis=2, dtype=np.float64)
    return out


def _sample_chunks(spec: ChunkSpec) -> list:
    """The chunks the fingerprint samples: up to 8, evenly spaced."""
    n_samp = min(spec.C, _SAMPLE_CHUNKS)
    return sorted({int(i) for i in np.linspace(0, spec.C - 1, n_samp)})


def fingerprint_parts(source) -> tuple:
    """What the fingerprint hashes of ``source``'s partitions, row by row:
    its per-chunk mask sums ``[P, C]`` and, per sampled chunk, the strided
    row ``[P, L/stride]`` of every logical column (``{name: array}``).
    Partition p's rows depend on partition p alone, so the parts of
    partition ranges, concatenated in order, are the whole layout's
    (``repro_torch.sharded.fingerprint`` gathers them across ranks)."""
    spec = source.spec
    stride = max(1, spec.L // _SAMPLE_ELEMS)
    samples = []
    for c in _sample_chunks(spec):
        sl = source._fingerprint_slice(c, c + 1)
        samples.append({name: np.ascontiguousarray(sl[name][:, 0, ::stride])
                        for name in sorted(sl)})
    return np.ascontiguousarray(source.mask_chunk_sums()), samples


def content_fingerprint(spec: ChunkSpec, mask_sums: np.ndarray, samples) -> str:
    """sha256 over ``repr(spec)``, the mask sums and the samples of
    :func:`fingerprint_parts` — the reference's content hash."""
    h = hashlib.sha256()
    h.update(repr(spec).encode())
    h.update(np.ascontiguousarray(mask_sums).tobytes())
    for sample in samples:
        for name in sorted(sample):
            h.update(name.encode())
            h.update(np.ascontiguousarray(sample[name]).tobytes())
    return h.hexdigest()


class ChunkSource:
    """Base class: a [P, C, L] columnar dataset readable in chunk slices.

    ``spec`` is the *logical* shape contract — what the query closures see
    after any decode; ``encodings`` (name-sorted tuple of ``(column,
    Encoding)``) names the columns that :meth:`slice_cols` returns in
    *physical* form.  ``resident`` is True when the whole dataset lives on
    the device.  ``device_slices`` is True when :meth:`slice_cols` returns
    tensors already on that device (a view over resident data): sessions
    take them as they are, with no host staging.  ``_mask`` is never
    encoded.
    """

    spec: ChunkSpec
    resident: bool = False
    device_slices: bool = False
    encodings: tuple = ()

    def slice_cols(self, lo: int, hi: int) -> dict:
        """Columns of chunk range [lo, hi): dict of [P, hi-lo, ·] arrays
        (host NumPy for streaming sources), incl. ``_mask``; encoded
        columns come back physical."""
        raise NotImplementedError

    def read_into(self, lo: int, hi: int, out: Dict[str, np.ndarray]) -> None:
        """Copy the slice [lo, hi) into ``out`` (writable host arrays of
        :meth:`step_slice_like`'s shapes).  Streaming sources copy from
        storage straight into them; this default goes through
        :meth:`slice_cols`."""
        for k, v in self.slice_cols(lo, hi).items():
            np.copyto(out[k], _numpy(v))

    def slice_parts(self, plo: int, phi: int, lo: int, hi: int) -> dict:
        """Columns of partitions [plo, phi) over chunks [lo, hi): the
        ``[phi-plo, hi-lo, ·]`` rows of :meth:`slice_cols`.  This default
        reads every partition and keeps the rows asked for; the file-backed
        sources and the views override it to read those partitions alone."""
        return {k: v[plo:phi] for k, v in self.slice_cols(lo, hi).items()}

    def read_parts_into(self, plo: int, phi: int, lo: int, hi: int,
                        out: Dict[str, np.ndarray]) -> None:
        """:meth:`read_into` for partitions [plo, phi) only."""
        for k, v in self.slice_parts(plo, phi, lo, hi).items():
            np.copyto(out[k], _numpy(v))

    def mask_sums_parts(self, plo: int, phi: int) -> np.ndarray:
        """:meth:`mask_chunk_sums` of partitions [plo, phi), ``[phi-plo, C]``."""
        return self.mask_chunk_sums()[plo:phi]

    def physical_columns(self) -> Tuple[ColumnSpec, ...]:
        """Column table of the bytes :meth:`slice_cols` returns: encoded
        columns with their stored dtype and lane count."""
        if not self.encodings:
            return self.spec.columns
        enc = dict(self.encodings)
        return tuple(
            c if enc.get(c.name) is None else
            ColumnSpec(c.name, enc[c.name].physical_dtype(), c.trailing,
                       enc[c.name].lanes)
            for c in self.spec.columns)

    def step_slice_like(self, width: int) -> dict:
        """{name: (shape, dtype name)} of one *physical* [P, width, ·] slice."""
        s = self.spec
        return ChunkSpec(s.P, s.C, s.L, self.physical_columns()).slice_like(width)

    def mask_chunk_sums(self) -> np.ndarray:
        """Per-(partition, chunk) live-tuple counts, float64 [P, C] (exact
        integers), computed once."""
        if getattr(self, "_mask_sums", None) is None:
            self._mask_sums = _mask_sums(lambda lo, hi: self.slice_cols(lo, hi)["_mask"],
                                         self.spec.P, self.spec.C)
        return self._mask_sums

    def fingerprint(self) -> str:
        """The reference's content hash: sha256 over ``repr(spec)``, the
        per-chunk ``_mask`` sums and strided samples ``[:, 0, ::stride]``
        of every column at up to 8 evenly spaced chunks.  A function of
        the logical data, not of the storage: equal across sources, and
        across the two packages, for the same rows.  Best-effort (sampled),
        as the reference's."""
        if getattr(self, "_fingerprint", None) is None:
            self._fingerprint = content_fingerprint(self.spec, *fingerprint_parts(self))
        return self._fingerprint

    def _fingerprint_slice(self, lo: int, hi: int) -> dict:
        """Host NumPy *logical* columns of [lo, hi): encoded columns are
        decoded first (on the CPU), so an encoded copy fingerprints as the
        plain data."""
        sl = self.slice_cols(lo, hi)
        if self.encodings:
            sl = ENC.decode_cols({k: as_tensor(v).cpu() for k, v in sl.items()},
                                 self.encodings)
        return {k: _numpy(v) for k, v in sl.items()}


def _spec_from_arrays(arrays: dict) -> ChunkSpec:
    P, C, L = arrays["_mask"].shape[:3]
    cols = tuple(
        ColumnSpec(k, ENC.dtype_name(arrays[k].dtype),
                   tuple(int(d) for d in arrays[k].shape[3:]))
        for k in sorted(arrays))
    return ChunkSpec(int(P), int(C), int(L), cols)


class InMemorySource(ChunkSource):
    """Resident ``[P, C, L]`` tensors (moved to ``device`` when given; a
    no-op for tensors already there).  ``slice_cols`` is the lazy slicing
    the session always did."""

    resident = True

    def __init__(self, shards: dict, device=None):
        if "_mask" not in shards:
            raise ValueError("shards dict must include a '_mask' column")
        self.shards = {k: as_tensor(v) if device is None
                       else as_tensor(v).to(device) for k, v in shards.items()}
        self.spec = _spec_from_arrays(self.shards)

    def slice_cols(self, lo: int, hi: int) -> dict:
        return {k: v[:, lo:hi] for k, v in self.shards.items()}

    def mask_chunk_sums(self) -> np.ndarray:
        # one device-side reduction; only the [P, C] result crosses to host.
        # A chunk's sum of 0/1 rows is exact in float32 up to 2**24 rows,
        # and summing a float32 mask in float64 would first make a float64
        # copy of all of it (twice the mask's bytes on the device)
        if getattr(self, "_mask_sums", None) is None:
            mask = self.shards["_mask"]
            exact32 = mask.dtype == torch.float32 and mask.shape[2] <= 1 << 24
            self._mask_sums = _numpy(mask.sum(
                dim=2, dtype=torch.float32 if exact32 else torch.float64).double())
        return self._mask_sums


class _HostColumns(ChunkSource):
    """Shared by the file-backed sources: ``self._host`` maps each column
    to a host [P, C, ·] array (usually a read-only mmap)."""

    _host: Dict[str, np.ndarray]

    def slice_cols(self, lo: int, hi: int) -> dict:
        return self.slice_parts(0, self.spec.P, lo, hi)

    def slice_parts(self, plo: int, phi: int, lo: int, hi: int) -> dict:
        # only the slice of those partitions is materialized on the host
        return {k: np.ascontiguousarray(v[plo:phi, lo:hi]) for k, v in self._host.items()}

    def read_into(self, lo: int, hi: int, out: Dict[str, np.ndarray]) -> None:
        self.read_parts_into(0, self.spec.P, lo, hi, out)

    def read_parts_into(self, plo: int, phi: int, lo: int, hi: int,
                        out: Dict[str, np.ndarray]) -> None:
        # each partition's rows [lo, hi) are contiguous on disk: one strided
        # copy per column straight into the caller's buffer, no temporary
        for k, v in self._host.items():
            np.copyto(out[k], v[plo:phi, lo:hi])

    def mask_chunk_sums(self) -> np.ndarray:
        if getattr(self, "_mask_sums", None) is None:
            self._mask_sums = self.mask_sums_parts(0, self.spec.P)
        return self._mask_sums

    def mask_sums_parts(self, plo: int, phi: int) -> np.ndarray:
        # only the mask column of those partitions is read, in bounded steps
        mask = self._host["_mask"]
        return _mask_sums(lambda lo, hi: mask[plo:phi, lo:hi], phi - plo, self.spec.C)


class NpyMmapSource(_HostColumns):
    """Memory-mapped columnar ``.npy`` files: ``<dir>/<column>.npy``, each
    a [P, C, L] array, ``_mask.npy`` required — the reference's layout.
    A slice read pages in only that chunk range."""

    def __init__(self, directory):
        self.directory = Path(directory)
        paths = sorted(self.directory.glob("*.npy"))
        if not paths:
            raise FileNotFoundError(f"no .npy columns under {self.directory}")
        self._host = {p.stem: np.load(p, mmap_mode="r") for p in paths}
        if "_mask" not in self._host:
            raise ValueError(f"{self.directory} lacks _mask.npy")
        shape = self._host["_mask"].shape
        for k, v in self._host.items():
            if v.shape[:3] != shape[:3]:
                raise ValueError(f"column {k!r} shape {v.shape} does not match "
                                 f"_mask {shape}")
        self.spec = _spec_from_arrays(self._host)

    @staticmethod
    def save(shards: dict, directory) -> Path:
        """Write a [P, C, L] shards dict (tensors or arrays) as the
        mmap-able column layout."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        for k, v in shards.items():
            np.save(directory / f"{k}.npy", _numpy(v))
        return directory


class EncodedSource(_HostColumns):
    """Dictionary-coded / bit-packed *physical* columns behind the plain
    *logical* ``spec``: the streamed bytes shrink, the results do not
    change (the decode is exact).  Built by :meth:`from_shards` (encode in
    host memory) or :meth:`save` + ``EncodedSource(directory)`` (mmap'd
    ``<column>.npy`` + ``encodings.json``, the reference's files).  Always
    streaming; the fingerprint is the plain data's."""

    def __init__(self, directory):
        self.directory = Path(directory)
        meta = json.loads((self.directory / "encodings.json").read_text())
        encs = {}
        for name, d in meta.items():
            if d["kind"] == "dict":
                encs[name] = ENC.DictEncoding(
                    values=tuple(d["values"]), code_dtype=d["code_dtype"],
                    logical_dtype=d["logical_dtype"])
            else:
                encs[name] = ENC.BitPackedEncoding(
                    bits=int(d["bits"]), logical_dtype=d["logical_dtype"])
        phys = {p.stem: np.load(p, mmap_mode="r")
                for p in sorted(self.directory.glob("*.npy"))}
        self._init_from(phys, ENC.normalize_encodings(encs))

    def _init_from(self, phys, encodings):
        if "_mask" not in phys:
            raise ValueError("EncodedSource needs a plain '_mask' column")
        enc = dict(encodings)
        if "_mask" in enc:
            raise ValueError("'_mask' must never be encoded")
        self._host = phys
        self.encodings = encodings
        P, C, L = phys["_mask"].shape[:3]
        cols = []
        for name in sorted(phys):
            e, v = enc.get(name), phys[name]
            trailing = tuple(int(d) for d in v.shape[3:])
            if e is None:
                cols.append(ColumnSpec(name, np.dtype(v.dtype).name, trailing))
                continue
            if v.shape[2] * e.lanes != L:
                raise ValueError(f"column {name!r}: physical chunk length "
                                 f"{v.shape[2]} x {e.lanes} lanes != L={L}")
            cols.append(ColumnSpec(name, e.logical_dtype, trailing))
        self.spec = ChunkSpec(int(P), int(C), int(L), tuple(cols))

    @classmethod
    def from_shards(cls, shards: dict, encodings):
        """Encode a [P, C, L] shards dict (tensors or arrays) on the host."""
        encodings = ENC.normalize_encodings(encodings)
        enc = dict(encodings)
        phys = {}
        for name, v in shards.items():
            a = _numpy(v)
            e = enc.get(name)
            phys[name] = a if e is None else ENC.encode_array(a, e)
        self = cls.__new__(cls)
        self.directory = None
        self._init_from(phys, encodings)
        return self

    @staticmethod
    def save(shards: dict, directory, encodings) -> Path:
        """Write the physical column layout + ``encodings.json``."""
        encodings = ENC.normalize_encodings(encodings)
        enc = dict(encodings)
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        meta = {}
        for name, v in shards.items():
            a = _numpy(v)
            e = enc.get(name)
            np.save(directory / f"{name}.npy",
                    a if e is None else ENC.encode_array(a, e))
            if isinstance(e, ENC.DictEncoding):
                meta[name] = {"kind": "dict", "values": list(e.values),
                              "code_dtype": e.code_dtype,
                              "logical_dtype": e.logical_dtype}
            elif e is not None:
                meta[name] = {"kind": "bitpack", "bits": e.bits,
                              "logical_dtype": e.logical_dtype}
        (directory / "encodings.json").write_text(json.dumps(meta, indent=1))
        return directory


class ParquetSource(ChunkSource):
    """Columnar parquet partitions: ``<dir>/part-*.parquet``, one file of
    *live* rows a partition and no mask column — liveness comes from the
    row counts, laid out as :func:`repro_torch.randomize.pack_partitions`
    lays it out (ragged tails padded with zeros and ``_mask == 0``; C is
    the longest partition's chunks, at least ``min_chunks``).

    A slice [lo, hi) is the row range [lo·L, hi·L) of each partition, read
    with column projection from the row groups that cover it, never the
    whole file.  ``read_row_groups`` has a fixed cost a call, so a
    sequential scan reads ahead: a read covers up to ``readahead`` row
    groups, and later slices are served from that cached block until they
    run past it.  One block is cached a partition, and the groups read
    past the covering ones are clamped to ``readahead_bytes / P`` a
    partition, so the host cache stays under ``readahead_bytes`` plus one
    covering read however large the writer's row groups are — never
    O(dataset).  Slices are host arrays, staged by the session's
    prefetcher like :class:`NpyMmapSource`'s.  Needs the optional
    ``pyarrow`` package, imported when a source is built or saved.
    """

    def __init__(self, directory, *, chunk_len: int, min_chunks: Optional[int] = None,
                 columns: Optional[List[str]] = None, readahead: int = 8,
                 readahead_bytes: int = 64 << 20):
        _, pq = _pyarrow()
        self.directory = Path(directory)
        paths = sorted(self.directory.glob("part-*.parquet"))
        if not paths:
            raise FileNotFoundError(f"no part-*.parquet files under {self.directory}")
        self._files = [pq.ParquetFile(p, memory_map=True) for p in paths]
        self._rows = [f.metadata.num_rows for f in self._files]
        self._readahead = max(1, int(readahead))
        self._readahead_bytes = int(readahead_bytes)
        self._block: List[Optional[tuple]] = [None] * len(self._files)
        L = int(chunk_len)
        C = max(-(-n // L) for n in self._rows)
        if min_chunks is not None:
            C = max(C, int(min_chunks))
        self.chunk_len = L
        schema = self._files[0].schema_arrow
        self._names = sorted(columns if columns is not None else schema.names)
        self._dtypes = {n: np.dtype(schema.field(n).type.to_pandas_dtype())
                        for n in self._names}
        cols = [ColumnSpec(n, self._dtypes[n].name) for n in self._names]
        cols.append(ColumnSpec("_mask", "float32"))
        self.spec = ChunkSpec(len(self._files), C, L, tuple(sorted(cols)))
        self._row_bytes = max(1, sum(d.itemsize for d in self._dtypes.values()))
        # row-group boundaries a file, for covering-group reads
        self._rg_starts = []
        for f in self._files:
            starts = np.zeros(f.metadata.num_row_groups + 1, np.int64)
            for g in range(f.metadata.num_row_groups):
                starts[g + 1] = starts[g] + f.metadata.row_group(g).num_rows
            self._rg_starts.append(starts)

    @staticmethod
    def save(parts: List[dict], directory, *, row_group_len: int = 1 << 16) -> Path:
        """Write ragged partition dicts (``randomize.*``'s output; tensors
        or arrays) as ``part-*.parquet`` files of live rows.  ``_mask``
        columns are dropped: parquet stores live rows only."""
        pa, pq = _pyarrow()
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        for i, p in enumerate(parts):
            table = pa.table({k: _numpy(v) for k, v in p.items() if k != "_mask"})
            pq.write_table(table, directory / f"part-{i:05d}.parquet",
                           row_group_size=row_group_len)
        return directory

    def _covering_block(self, part: int, row_lo: int, row_hi: int):
        """The cached (block_lo, block_hi, {column: array}) covering rows
        [row_lo, row_hi) of ``part``: read, when the cache misses, from the
        covering row groups and up to ``readahead`` groups in all, within
        this partition's share of ``readahead_bytes``."""
        blk = self._block[part]
        if blk is not None and blk[0] <= row_lo and row_hi <= blk[1]:
            return blk
        f, starts = self._files[part], self._rg_starts[part]
        g_lo = int(np.searchsorted(starts, row_lo, side="right")) - 1
        g_hi = int(np.searchsorted(starts, row_hi, side="left"))
        budget_rows = self._readahead_bytes // (len(self._files) * self._row_bytes)
        while (g_hi < f.metadata.num_row_groups and g_hi - g_lo < self._readahead
               and int(starts[g_hi + 1] - starts[g_lo]) <= budget_rows):
            g_hi += 1
        self._block[part] = None  # the old block goes before the new one is read
        table = f.read_row_groups(list(range(g_lo, g_hi)), columns=self._names)
        arrs = {n: table.column(n).to_numpy(zero_copy_only=False) for n in self._names}
        blk = self._block[part] = (int(starts[g_lo]), int(starts[g_hi]), arrs)
        return blk

    def read_parts_into(self, plo: int, phi: int, lo: int, hi: int,
                        out: Dict[str, np.ndarray]) -> None:
        # each partition's live rows of [lo·L, hi·L) at the head of its
        # row, zeros and _mask == 0 after them
        L = self.chunk_len
        for p in range(plo, phi):
            row_lo, row_hi = lo * L, min(hi * L, self._rows[p])
            n = max(0, row_hi - row_lo)
            if n:
                blk_lo, _, arrs = self._covering_block(p, row_lo, row_hi)
            for name in self._names:
                dst = out[name][p - plo].reshape(-1)
                if n:
                    dst[:n] = arrs[name][row_lo - blk_lo:row_hi - blk_lo]
                dst[n:] = 0
            mask = out["_mask"][p - plo].reshape(-1)
            mask[:n] = 1.0
            mask[n:] = 0.0

    def read_into(self, lo: int, hi: int, out: Dict[str, np.ndarray]) -> None:
        self.read_parts_into(0, self.spec.P, lo, hi, out)

    def slice_parts(self, plo: int, phi: int, lo: int, hi: int) -> dict:
        out = {n: np.empty(shape, np.dtype(dt))
               for n, (shape, dt) in self.spec._replace(P=phi - plo).slice_like(hi - lo).items()}
        self.read_parts_into(plo, phi, lo, hi, out)
        return out

    def slice_cols(self, lo: int, hi: int) -> dict:
        return self.slice_parts(0, self.spec.P, lo, hi)

    def mask_chunk_sums(self) -> np.ndarray:
        if getattr(self, "_mask_sums", None) is None:
            self._mask_sums = self.mask_sums_parts(0, self.spec.P)
        return self._mask_sums

    def mask_sums_parts(self, plo: int, phi: int) -> np.ndarray:
        # liveness is a function of the row counts: no read
        C, L = self.spec.C, self.spec.L
        n = np.asarray(self._rows[plo:phi], np.int64)[:, None]
        return np.clip(n - np.arange(C, dtype=np.int64)[None, :] * L, 0, L).astype(np.float64)


def _pyarrow():
    """``(pyarrow, pyarrow.parquet)``, or the reference's ImportError."""
    try:
        import pyarrow
        import pyarrow.parquet
    except ImportError as e:  # an optional dependency
        raise ImportError("ParquetSource needs the optional 'pyarrow' package "
                          "(pip install pyarrow)") from e
    return pyarrow, pyarrow.parquet


class RepartitionedSource(ChunkSource):
    """A P'-way view of a P-way source — elastic resume.

    Merging (P' < P, P % P' == 0, k = P / P'): new partition i
    round-robin-interleaves the chunk streams of old partitions
    [i·k, (i+1)·k) — new chunk j is old (partition i·k + j mod k, chunk
    j // k) — so C' = k·C.  Splitting (P' > P, P' % P == 0, k = P' / P,
    k | C): new partition p·k + j de-interleaves old partition p's stream,
    taking old chunks j, j+k, j+2k, …, so C' = C / k.  The reference's
    convention: when every old partition has scanned the same chunk prefix
    [0, cur), the scanned rows are the prefix [0, cur·k) (merge) or
    [0, cur/k) (split, k | cur) of every new stream, so a resumed scan
    continues where the paused one stopped.  Merge and split by the same
    factor are mutual inverses (:func:`repartition` returns the inner
    source for the round trip).

    The view is never ``resident``: no whole second copy of the data
    exists in the new layout.  Over a resident inner each round-slice is
    gathered where the inner's tensors live — on the card for card data —
    and ``device_slices`` is True; over a streaming inner the slice is
    gathered on the host and :meth:`read_into` (the base class's) copies it
    into the caller's staging.  ``fingerprint`` is the reference's content
    hash of the view's own layout, equal to the reference's
    ``RepartitionedSource`` fingerprint on the same rows.
    """

    def __init__(self, inner: ChunkSource, partitions: int):
        if not isinstance(inner, ChunkSource):
            raise TypeError("RepartitionedSource wraps a ChunkSource; use "
                            "repartition() for plain shards dicts")
        P, C, L = inner.spec.P, inner.spec.C, inner.spec.L
        P_new = int(partitions)
        if P_new <= 0:
            raise ValueError(f"partitions must be positive, got {partitions}")
        if (P % P_new) if P_new <= P else (P_new % P):
            raise ValueError(
                f"cannot repartition {P} -> {P_new}: the new partition "
                "count must divide the old one (merge) or be a multiple "
                "of it (split)")
        if P_new <= P:
            k = P // P_new
            C_new = C * k
        else:
            k = P_new // P
            if C % k:
                raise ValueError(
                    f"cannot split {P} -> {P_new}: the factor {k} must "
                    f"divide the per-partition chunk count C={C}")
            C_new = C // k
        self.inner = inner
        self._factor = k
        self._is_merge = P_new <= P
        self.spec = ChunkSpec(P_new, C_new, L, inner.spec.columns)
        # the physical layout is the data's, not the partitioning's
        self.encodings = inner.encodings
        self.device_slices = inner.resident or inner.device_slices

    def _index_maps(self, lo: int, hi: int, plo: int = 0, phi: int = None):
        """Old (partition, chunk within [olo, ohi)) index grids
        [phi-plo, hi-lo] of new chunks [lo, hi) of new partitions
        [plo, phi) (all of them by default), and [olo, ohi)."""
        k = self._factor
        j = np.arange(lo, hi)
        i = np.arange(plo, self.spec.P if phi is None else phi)
        if self._is_merge:
            olo, ohi = lo // k, (hi - 1) // k + 1
            rows = i[:, None] * k + (j % k)[None, :]
            cols = np.broadcast_to((j // k)[None, :] - olo, rows.shape)
        else:
            olo, ohi = lo * k, hi * k
            rows = np.broadcast_to((i // k)[:, None], (i.size, j.size))
            cols = (j[None, :] - lo) * k + (i % k)[:, None]
        return rows, cols, olo, ohi

    def slice_cols(self, lo: int, hi: int) -> dict:
        return self.slice_parts(0, self.spec.P, lo, hi)

    def slice_parts(self, plo: int, phi: int, lo: int, hi: int) -> dict:
        # new partitions [plo, phi) read old partitions [rlo, rhi) alone
        rows, cols, olo, ohi = self._index_maps(lo, hi, plo, phi)
        rlo = int(rows.min())
        rows = rows - rlo
        block = self.inner.slice_parts(rlo, rlo + int(rows.max()) + 1, olo, ohi)
        out, idx = {}, {}
        for name, v in block.items():
            if isinstance(v, torch.Tensor):  # gathered where the data lives
                if v.device not in idx:
                    idx[v.device] = tuple(torch.from_numpy(np.array(a)).to(v.device)
                                          for a in (rows, cols))
                out[name] = v[idx[v.device]]
            else:
                out[name] = np.asarray(v)[rows, cols]
        return out

    def mask_chunk_sums(self) -> np.ndarray:
        if getattr(self, "_mask_sums", None) is None:
            self._mask_sums = self.mask_sums_parts(0, self.spec.P)
        return self._mask_sums

    def mask_sums_parts(self, plo: int, phi: int) -> np.ndarray:
        # an index remap of the inner counts: no data read
        rows, cols, _, _ = self._index_maps(0, self.spec.C, plo, phi)
        rlo = int(rows.min())
        return self.inner.mask_sums_parts(rlo, int(rows.max()) + 1)[rows - rlo, cols]


class PartitionRangeSource(ChunkSource):
    """Partitions [lo, hi) of a source: one rank's share of a layout that
    several processes scan together (``repro_torch.sharded``).

    ``spec`` is the range's own ``[hi-lo, C, L]`` contract; every read —
    :meth:`slice_cols`, :meth:`read_into` (what the prefetcher's pinned
    staging takes), :meth:`step_slice_like`, :meth:`mask_chunk_sums` —
    touches those partitions alone (through the inner source's
    ``*_parts`` methods).  :meth:`fingerprint` is the whole layout's, so a
    checkpoint written by several ranks names the data one process would
    see.  A ``PartitionLostError`` from the inner source names partitions
    of the whole layout.  Over a resident source, use its rows directly
    (``repro_torch.sharded.device_put_slice``): this view streams.
    """

    def __init__(self, inner: ChunkSource, lo: int, hi: int):
        if not 0 <= lo < hi <= inner.spec.P:
            raise ValueError(f"partition range [{lo}, {hi}) is not inside "
                             f"the source's {inner.spec.P} partitions")
        self.inner, self.lo, self.hi = inner, int(lo), int(hi)
        self.spec = inner.spec._replace(P=self.hi - self.lo)
        self.encodings = inner.encodings
        self.device_slices = inner.device_slices

    def slice_cols(self, lo: int, hi: int) -> dict:
        return self.inner.slice_parts(self.lo, self.hi, lo, hi)

    def read_into(self, lo: int, hi: int, out: Dict[str, np.ndarray]) -> None:
        self.inner.read_parts_into(self.lo, self.hi, lo, hi, out)

    def mask_chunk_sums(self) -> np.ndarray:
        if getattr(self, "_mask_sums", None) is None:
            self._mask_sums = self.inner.mask_sums_parts(self.lo, self.hi)
        return self._mask_sums

    def fingerprint(self) -> str:
        return self.inner.fingerprint()


def as_source(data) -> ChunkSource:
    """A ChunkSource passes through; a plain [P, C, L] shards dict wraps
    into an :class:`InMemorySource`."""
    if isinstance(data, ChunkSource):
        return data
    if isinstance(data, dict):
        return InMemorySource(data)
    raise TypeError(f"expected a ChunkSource or a [P, C, L] shards dict, got "
                    f"{type(data).__name__}")


def repartition(data, partitions: int) -> ChunkSource:
    """P'-way :class:`RepartitionedSource` view of ``data``: the source
    itself when the partition count already matches, and the inner source
    when ``data`` is a view of it with P' partitions (merge and split are
    mutual inverses, so no view of a view is built for a round trip)."""
    src = as_source(data)
    partitions = int(partitions)
    if partitions == src.spec.P:
        return src
    if isinstance(src, RepartitionedSource) and partitions == src.inner.spec.P:
        return src.inner
    return RepartitionedSource(src, partitions)


def place(source: ChunkSource, device) -> ChunkSource:
    """``source`` with its resident tensors on ``device`` (a no-op for
    tensors already there): a resident source, or the resident data under
    a view whose slices are gathered on the device."""
    if source.resident:
        return InMemorySource(source.shards, device=device)
    if isinstance(source, RepartitionedSource) and source.device_slices:
        return RepartitionedSource(place(source.inner, device), source.spec.P)
    return source

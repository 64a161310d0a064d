"""K13 — lane gather and one-hot lane scatter (source: ``csrc/k13_lane.cu``).

The counterparts of ``experiments/test_lane_gather.py:57``
(``bucketed_gather``) and ``:82`` (``bucketed_scatter``): a transposed
(D, V) table in V/128 buckets of 128 columns, bucket b's offsets in row 8b
of an (8·V/128, 128) int32 array —

* :func:`lane_gather`: ``out[:, 128b + j] = T[:, 128b + offs[8b, j]]``;
* :func:`lane_scatter`: ``out[:, 128b + c] = T[:, 128b + c] + cast(Σ_{j:
  offs[8b, j] = c} G[:, 128b + j])`` — duplicates summed in float32 in
  increasing j, cast to the table's type, then added.

Tables are float32 or bfloat16.  Offsets outside [0, 128) are an error:
the plain versions raise on the CPU, and the kernels clamp them into the
bucket.  No path of the package runs these.

Both are streaming passes, bound by bytes (each input read once, the
output written once).  Each call is one launch of a one-shot grid, a
block a tile of :func:`plan`'s rows × one bucket.  The gather's tile
arrives by cp.async and leaves permuted in 16-byte stores.  The scatter
holds its T chunks in registers and stages G; while both are in flight
the block builds the bucket's contributor lists in parallel, then adds
each column's contributors in increasing j (the plain version's order,
so it is bitwise its plain version) and stores T + the sums.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches made through :func:`lane_gather` / :func:`lane_scatter`,
#: by element type ("" float32, "bf16")
launches = {("lane_gather", ""): 0, ("lane_gather", "bf16"): 0,
            ("lane_scatter", ""): 0, ("lane_scatter", "bf16"): 0}

_LIB = "k13_lane"
BUCKET = 128
#: a tile's rows by kernel and element size where the grid is large: the
#: fastest at (256, 24576) on an H100 (``kernel_split.py --kernel k13``);
#: and the least a plan halves down to
MAX_ROWS = {("gather", 4): 32, ("gather", 2): 64, ("scatter", 4): 32, ("scatter", 2): 32}
MIN_ROWS = 8
#: tiles an SM the plan wants before it stops halving the tile
TILES_PER_SM = 4


def plan(kind: str, d: int, v: int, elem_bytes: int, sms: int) -> int:
    """Rows a tile of the ``kind`` ("gather" or "scatter") kernel takes
    for a (d, v) table of ``elem_bytes``-byte elements on a card of
    ``sms`` SMs: MAX_ROWS, halved down to MIN_ROWS while the grid of
    (v / 128) × ceil(d / rows) tiles would give fewer than TILES_PER_SM
    an SM."""
    rows = MAX_ROWS[kind, elem_bytes]
    while rows > MIN_ROWS and (v // BUCKET) * -(-d // rows) < TILES_PER_SM * sms:
        rows //= 2
    return rows


def bucket_offsets(offs: torch.Tensor) -> torch.Tensor:
    """(V/128, 128) int64: each bucket's offsets (row 8b of ``offs``)."""
    return offs[0::8].long()


def global_columns(offs: torch.Tensor) -> torch.Tensor:
    """(V,) int64: the table column each output column of the gather
    reads, ``128b + offs[8b, j]`` (the scatter's target columns)."""
    o = bucket_offsets(offs)
    if o.numel() and (int(o.min()) < 0 or int(o.max()) >= BUCKET):
        raise ValueError(f"offsets outside [0, {BUCKET})")
    base = torch.arange(o.shape[0], device=o.device)[:, None] * BUCKET
    return (base + o).reshape(-1)


def lane_gather_plain(table, offs):
    return table.index_select(1, global_columns(offs))


def lane_scatter_plain(table, grads, offs):
    d, v = table.shape
    nb = v // BUCKET
    o = bucket_offsets(offs)
    global_columns(offs)  # range check
    g = grads.float().reshape(d, nb, BUCKET)
    acc = torch.zeros((d, nb, BUCKET), dtype=torch.float32, device=table.device)
    # in increasing j, one contributor per (row, bucket) a pass: the
    # kernel's float32 summation order
    for j in range(BUCKET):
        acc.scatter_add_(2, o[:, j].reshape(1, nb, 1).expand(d, nb, 1), g[:, :, j:j + 1])
    s = acc.reshape(d, v).to(table.dtype).float()
    return (table.float() + s).to(table.dtype)


def _check(table, offs, grads=None):
    d, v = table.shape
    _args.expect(table, "table", _args.TABLE_DTYPES, (d, v))
    if v % BUCKET:
        raise ValueError(f"table: {v} columns is not a multiple of {BUCKET}")
    _args.expect(offs, "offs", torch.int32, (8 * (v // BUCKET), BUCKET))
    tensors = [table]
    if grads is not None:
        _args.expect(grads, "grads", table.dtype, (d, v))
        tensors.append(grads)
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("tables must start on a 16-byte boundary")
    return d, v, int(table.dtype == torch.bfloat16)


def lane_gather(table: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The bucketed lane gather of a (D, V) table, as a new (D, V) tensor."""
    if _args.on_cpu(table, offs):
        return lane_gather_plain(table, offs)
    d, v, bf16 = _check(table, offs)
    out = torch.empty_like(table)
    lib = _lib()
    rows = plan("gather", d, v, table.element_size(), _args.sm_count(table))
    status = lib.k13_lane_gather(_args.ptr(table), _args.ptr(offs), _args.ptr(out), d, v, bf16,
                                 rows, _args.stream(table))
    build.check(lib, status, "K13 lane_gather launch")
    launches["lane_gather", "bf16" if bf16 else ""] += 1
    return out


def lane_scatter(table: torch.Tensor, grads: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The bucketed one-hot lane scatter of ``grads`` into a (D, V) table,
    as a new (D, V) tensor."""
    if _args.on_cpu(table, grads, offs):
        return lane_scatter_plain(table, grads, offs)
    d, v, bf16 = _check(table, offs, grads)
    out = torch.empty_like(table)
    lib = _lib()
    rows = plan("scatter", d, v, table.element_size(), _args.sm_count(table))
    status = lib.k13_lane_scatter(_args.ptr(table), _args.ptr(grads), _args.ptr(offs),
                                  _args.ptr(out), d, v, bf16, rows, _args.stream(table))
    build.check(lib, status, "K13 lane_scatter launch")
    launches["lane_scatter", "bf16" if bf16 else ""] += 1
    return out


def _lib():
    lib = build.load(_LIB)
    if lib.k13_lane_gather.argtypes is None:
        P, I = _args.P, _args.I
        lib.k13_lane_gather.argtypes = [P, P, P, I, I, I, I, P]
        lib.k13_lane_gather.restype = I
        lib.k13_lane_scatter.argtypes = [P, P, P, P, I, I, I, I, P]
        lib.k13_lane_scatter.restype = I
    return lib

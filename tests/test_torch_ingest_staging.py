"""``KernelSketch.update``'s page-locked staging (``repro_torch.staging``).

On the CPU: CPU tables never make the ring's slots and leave its counters
at 0, and what the three modes compute and refuse is what the plain paths
compute and refuse.  On the card (marker ``gpu``, skipped without one):
host blocks staged through the ring fold to the plain fold's table and to
the table of the same blocks passed as device tensors, bit for bit, while
the caller overwrites its arrays as soon as each call returns; a call
returns while the stream is still busy (no synchronise); a larger block
grows the slots; empty and refused blocks stage nothing.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import countsketch as cs
from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema
from repro_torch.kernels.ops import MODES, KernelSketch

KEY_POOL = 96          # distinct keys a test stream draws from, so cells collide
SLEEP_CYCLES = 100_000_000   # about 50 ms of a spinning kernel at the H100's clock


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spec(ranges=(64, 64), w=3):
    return sk.mod_sketch_spec(KeySchema((1 << 32, 1 << 32)), [(0,), (1,)], ranges, w)


def _sketch(mode, device, spec=None, **kw):
    """Hash params drawn on the CPU from one seed, so every device's sketch
    hashes alike."""
    return KernelSketch(spec or _spec(), torch.Generator().manual_seed(7), tile_h=128,
                        device=device, mode=mode, **kw)


def _fill(rng, items, freqs, mode):
    """Overwrite ``items`` [n, 2] and ``freqs`` [n] in place with a seeded
    block: keys from a small pool, counts 0-9 (-9..9 in signed mode)."""
    pool = np.random.default_rng(11).integers(0, 1 << 32, size=(KEY_POOL, 2), dtype=np.uint64)
    items[:] = pool[rng.integers(0, KEY_POOL, size=items.shape[0])].astype(np.uint32)
    lo = -9 if mode == "signed" else 0
    freqs[:] = rng.integers(lo, 10, size=freqs.shape[0])


def _blocks(mode, n_blocks, n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_blocks):
        items, freqs = np.empty((n, 2), np.uint32), np.empty(n, np.int64)
        _fill(rng, items, freqs, mode)
        out.append((items, freqs))
    return out


def _plain_table(mode, ks, blocks):
    """The plain paths of ``core`` (not the kernels' wrappers) on the CPU."""
    spec = ks.spec
    zeros = torch.zeros((spec.width, spec.table_size), dtype=ks.table.dtype)
    if mode == "signed":
        st = cs.CountSketchState(params=ks.cs_params, table=zeros)
        for items, freqs in blocks:
            st = cs.update(spec, st, items, freqs)
        return st.table
    st = sk.SketchState(params=ks.params, table=zeros)
    fold = sk.update_conservative if mode == "conservative" else sk.update
    for items, freqs in blocks:
        st = fold(spec, st, items, freqs)
    return st.table


def _untouched(ks):
    return ks.staging.slots == [] and ks.staging.staged_blocks == ks.staging.staging_waits == 0


# -- CPU -----------------------------------------------------------------------

@pytest.mark.parametrize("given", ["numpy", "tensor"])
@pytest.mark.parametrize("mode", MODES)
def test_cpu_tables_match_plain_paths_and_never_stage(mode, given):
    ks = _sketch(mode, "cpu")
    blocks = _blocks(mode, 4, 50)
    for items, freqs in blocks:
        if given == "tensor":
            ks.update(torch.from_numpy(items.astype(np.int64)), torch.from_numpy(freqs))
        else:
            ks.update(items, freqs)
    ks.update(np.empty((0, 2), np.uint32), np.empty(0, np.int64))
    assert torch.equal(ks.table[:, : ks.spec.table_size], _plain_table(mode, ks, blocks))
    assert _untouched(ks)


REFUSED = [
    ("linear", -1, "negative frequencies are not supported on int tables"),
    ("linear", 1 << 24, r"\|frequency\| >= 2\^24 overflows the int-table limb split: "
                        r"use the core.sketch path"),
    ("signed", -(1 << 24), r"\|frequency\| >= 2\^24 overflows the int-table limb split: "
                           r"use the core.countsketch path"),
    ("conservative", -1, "conservative update requires non-negative frequencies"),
    ("conservative", 1 << 31, "per-arrival frequency exceeds the int32 table range"),
]


@pytest.mark.parametrize("mode,bad,match", REFUSED)
def test_cpu_refusals_unchanged(mode, bad, match):
    ks = _sketch(mode, "cpu")
    (items, freqs), = _blocks(mode, 1, 20)
    ks.update(items, freqs)
    before = ks.table.clone()
    freqs[7] = bad
    with pytest.raises(ValueError, match=match):
        ks.update(items, freqs)
    assert torch.equal(ks.table, before) and _untouched(ks)


# -- on the card -----------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_staged_blocks_fold_to_the_plain_and_device_tensor_tables(cuda, mode):
    staged, direct, plain = (_sketch(mode, cuda), _sketch(mode, cuda), _sketch(mode, "cpu"))
    rng = np.random.default_rng(5)
    items, freqs = np.empty((700, 2), np.uint32), np.empty(700, np.int64)
    _fill(rng, items, freqs, mode)
    torch.cuda._sleep(SLEEP_CYCLES)          # the first copies stay pending behind it
    for _ in range(40):
        direct.update(torch.from_numpy(items.astype(np.int64)).to(cuda),
                      torch.from_numpy(freqs).to(cuda))
        plain.update(items, freqs)
        staged.update(items, freqs)
        _fill(rng, items, freqs, mode)       # the caller reuses its arrays at once
    torch.cuda.synchronize()
    assert torch.equal(staged.table.cpu(), plain.table)
    assert torch.equal(direct.table.cpu(), plain.table)
    assert staged.staging.staged_blocks == 40 and len(staged.staging.slots) == 2
    assert _untouched(direct)


@pytest.mark.gpu
def test_update_returns_while_the_card_still_works(cuda):
    spec = _spec(ranges=(4096, 4096), w=4)
    ks = _sketch("conservative", cuda, spec=spec, block_b=1 << 16)
    (items, freqs), = _blocks("conservative", 1, 1 << 16)
    items[:] = np.random.default_rng(9).integers(0, 1 << 32, size=items.shape, dtype=np.uint64)
    ks.update(items, freqs)                  # builds the library, makes the slots
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    slept = torch.cuda.Event()
    slept.record()
    ks.update(items, freqs)
    assert not slept.query(), "update waited for work queued before it"
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert ks.staging.staged_blocks == 2


@pytest.mark.gpu
def test_a_larger_block_grows_the_slots(cuda):
    ks, plain = _sketch("conservative", cuda), _sketch("conservative", "cpu")
    sizes = (100, 300, 50, 400)
    blocks = [_blocks("conservative", 1, n, seed=n)[0] for n in sizes]
    for items, freqs in blocks:
        ks.update(items, freqs)
        plain.update(items, freqs)
    keys = [slot.buffers["keys"][1].size for slot in ks.staging.slots]
    counts = [slot.buffers["freqs"][1].size for slot in ks.staging.slots]
    assert keys == [2 * 100, 2 * 400] and counts == [100, 400]
    torch.cuda.synchronize()
    assert torch.equal(ks.table.cpu(), plain.table)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,bad,match", REFUSED)
def test_empty_and_refused_blocks_stage_nothing(cuda, mode, bad, match):
    ks = _sketch(mode, cuda)
    ks.update(np.empty((0, 2), np.uint32), np.empty(0, np.int64))
    assert _untouched(ks)
    (items, freqs), = _blocks(mode, 1, 20)
    ks.update(items, freqs)
    torch.cuda.synchronize()
    before = ks.table.clone()
    ks.update(np.empty((0, 2), np.uint32), np.empty(0, np.int64))
    freqs[7] = bad
    with pytest.raises(ValueError, match=match):
        ks.update(items, freqs)
    assert ks.staging.staged_blocks == 1
    assert torch.equal(ks.table, before)

"""The pedestrians' separation (`city/traffic._separation`): the plain
twin `separation_plain` on CPU tensors and the CUDA kernel
`ops/cuda/separation_kernel` on the card.  This file imports no jax.

On the CPU: `_separation` takes the plain code and launches nothing, an
unsupported device raises, and the benchmark's `no_separation` fault still
reaches `step_peds` through it.  On the card (`gpu`), each against the
plain twin on the same CUDA tensors: the walk's settled crowd of 10,000
(`kernel_probe.walk_crowd`) and a crowd packed at a crosswalk, bit for bit
in every row with at most two neighbours within the radius (a far column
adds an exact zero, so any order gives the same bits) and within the
rounding of a reordered sum elsewhere; peer counts of 1, 31, 10,007 (a
ragged tile) and 0; a slab of rows with `first` set, bit for bit those
rows of the whole call; and 16 chained `step_peds` frames whose discrete
state equals the plain chain's.
"""

import pytest
import torch

from benchmark import city_faults as BF
from w3d_torch.city import traffic as CT
from w3d_torch.ops.cuda import separation_kernel as SEP
from w3d_torch.utils import kernel_probe as KP

from torch_port_util import cuda_device  # noqa: F401

R = KP.SEP_RADIUS
EPS = 2.0 ** -23


def _square(n: int, side: float, seed: int, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((2, n), generator=g) * side + 100.0
    return xy[0].to(device), xy[1].to(device)


def test_cpu_takes_the_plain_code(monkeypatch):
    x, y = _square(300, 2.0, 1)
    calls, twin = [], CT.separation_plain

    def plain(*args):
        calls.append(args)
        return twin(*args)

    monkeypatch.setattr(CT, "separation_plain", plain)
    before = SEP.KERNEL.launches
    rx, ry = CT._separation(x, y, R)
    assert len(calls) == 1 and SEP.KERNEL.launches == before
    want = CT.separation_plain(x, y, R, CT.PedPeers(x, y))
    assert torch.equal(rx, want[0]) and torch.equal(ry, want[1])
    assert float(rx.abs().max()) > 0.5          # neighbours push


def test_an_unsupported_device_raises():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        CT._separation(x, x, R)


def test_the_no_separation_fault_reaches_step_peds():
    x, y = _square(200, 1.5, 2)
    g = torch.Generator().manual_seed(3)
    p = CT.PedState(x=x, y=y, gx=x + 1.0, gy=y + 1.0,
                    speed=torch.full_like(x, 0.003))
    draws = CT.PedDraws(*torch.rand((4, x.shape[0]), generator=g))
    good = CT.step_peds(p, draws)
    with BF.planted("no_separation"):
        bad = CT.step_peds(p, draws)
    again = CT.step_peds(p, draws)
    assert not torch.equal(good.x, bad.x) and torch.equal(good.x, again.x)


# ---------------------------------------------------------------------------
# the kernel on the card against its plain twin
# ---------------------------------------------------------------------------

def _terms(x, y, peers):
    """Per row, as the plain code forms them: the neighbours within the
    radius (self not counted), the sum of the terms' magnitudes |w ex| +
    |w ey|, and the length of the push before its normalisation."""
    ex = x[:, None] - peers.x[None, :]
    ey = y[:, None] - peers.y[None, :]
    d2 = ex * ex + ey * ey
    ix = peers.first + torch.arange(x.shape[0], device=x.device)
    near = (d2 < R ** 2) & (ix[:, None] != torch.arange(peers.x.shape[0],
                                                         device=x.device)[None, :])
    w = torch.where(near, 1.0 / torch.clamp(d2, min=1e-4), 0.0)
    rx, ry = torch.sum(w * ex, 1), torch.sum(w * ey, 1)
    return near.sum(1), (w * ex.abs() + w * ey.abs()).sum(1), torch.sqrt(rx * rx + ry * ry)


def _compare(x, y, peers=None) -> tuple[int, int]:
    """Kernel against plain twin: bit for bit on rows with at most two
    neighbours; elsewhere each component of the unit push within what
    adding k terms in two orders can move it, 2 k eps S / |r| (S the
    terms' magnitudes, r the push before its normalisation), twice over
    for the normalisation, plus 1e-6.  Returns the rows of each kind."""
    peers = CT.PedPeers(x, y) if peers is None else peers
    got = CT._separation(x, y, R, peers)
    want = CT.separation_plain(x, y, R, peers)
    k, s, norm = _terms(x, y, peers)
    few = k <= 2
    tol = 4.0 * k.float() * EPS * s / norm + 1e-6
    for a, b in zip(got, want):
        assert torch.equal(a[few], b[few])
        assert bool(((a - b).abs() <= tol)[~few].all())
    return int(few.sum()), int((~few).sum())


@pytest.fixture(scope="module")
def crowd():
    """The walk's crowd after 2,048 frames on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return KP.walk_crowd(torch.device("cuda"))


@pytest.mark.gpu
def test_the_settled_walk_crowd(cuda_device, crowd):
    peds = crowd[0]
    x, y = peds.x, peds.y
    before = SEP.KERNEL.launches
    got = CT._separation(x, y, R)
    want = CT.separation_plain(x, y, R, CT.PedPeers(x, y))
    assert SEP.KERNEL.launches == before + 1
    k = _terms(x, y, CT.PedPeers(x, y))[0]
    few = k <= 2
    assert int(few.sum()) > 9000 and int((k > 0).sum()) > 100
    for a, b in zip(got, want):
        assert torch.equal(a[few], b[few])
        assert float((a - b).abs().max()) <= 1e-6
    assert int((~few).sum()) > 0, "no row of the settled crowd has three neighbours"


@pytest.mark.gpu
def test_a_crowd_packed_at_a_crosswalk(cuda_device, crowd):
    x, y = KP.packed_crowd(crowd[0], crowd[1])
    few, many = _compare(x, y)
    assert many >= 300 and few > 9000


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 10007])
def test_peer_counts(cuda_device, n):
    x, y = _square(n, 0.5 if n < 100 else 10.0, n, cuda_device)
    few, many = _compare(x, y)
    assert few + many == n and (n == 1 or many > n // 4)
    if n == 1:
        got = CT._separation(x, y, R)
        assert float(got[0]) == 0.0 and float(got[1]) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [0, 5])
def test_no_peers(cuda_device, rows):
    x, y = _square(rows, 1.0, 4, cuda_device)
    none = torch.zeros(0, device=cuda_device)
    before = SEP.KERNEL.launches
    got = CT._separation(x, y, R, CT.PedPeers(none, none))
    want = CT.separation_plain(x, y, R, CT.PedPeers(none, none))
    assert SEP.KERNEL.launches == before
    assert all(torch.equal(a, b) and a.shape == (rows,) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_a_slab_is_the_whole_calls_rows(cuda_device, crowd, packed):
    x, y = KP.packed_crowd(crowd[0], crowd[1]) if packed else (crowd[0].x, crowd[0].y)
    whole = CT._separation(x, y, R)
    for a, b in ((0, 400), (3001, 6133), (9990, 10000)):
        part = CT._separation(x[a:b], y[a:b], R, CT.PedPeers(x, y, a))
        assert all(torch.equal(p, w[a:b]) for p, w in zip(part, whole)), (a, b)


def _close(a, b) -> bool:
    """Within 1e-5, or two ulps of a coordinate past 256 (3.05e-5 each),
    where a push an ulp apart can round the step to the next coordinate."""
    ulp = torch.nextafter(a.abs(), torch.full_like(a, float("inf"))) - a.abs()
    return bool(((a - b).abs() <= torch.clamp(2.0 * ulp, min=1e-5)).all())


@pytest.mark.gpu
def test_chained_frames_keep_the_discrete_state(cuda_device, crowd, monkeypatch):
    peds, nav, sl, _ = crowd
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    frames = []
    for _ in range(16):
        sl = CT.step_stoplights(sl)
        frames.append((sl, KP.ped_draws(peds.x.shape[0], gen)))

    def chain():
        p = peds
        for s, d in frames:
            p = CT.step_peds(p, d, nav=nav, stoplights=s)
        return p

    before = SEP.KERNEL.launches
    got = chain()
    assert SEP.KERNEL.launches == before + 16
    with monkeypatch.context() as m:
        m.setattr(CT, "_separation", lambda x, y, r, peers=None: CT.separation_plain(
            x, y, r, CT.PedPeers(x, y) if peers is None else peers))
        want = chain()
    for f in ("blk", "stage", "side"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("x", "y", "gx", "gy"):
        assert _close(getattr(got, f), getattr(want, f)), f
    assert int((got.stage != peds.stage).sum()) > 0      # some change stage

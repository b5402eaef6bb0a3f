"""Two-phase phase 2 of the port (``raster_cuda.rasterize_resolve``, kernel
B3b on the card) against the JAX package's ``rasterize_pallas_resolve``
(Pallas in interpret mode) with (item, cell) pairs that hold winners
turned off in both; the "any live copy" rule for an item listed twice; and
the dispatching winner filter equal to its plain version on the CPU. The
view is the frontal one of tests/test_torch_two_phase.py's terrain scene.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raster import I, T, _VIEWS, _port_work, _scene
from test_torch_two_phase import BIG_ID, MAX_WORK, _jax_work
from torch_parity import H, W, t
from vrenderer_tpu.ops import raster_pallas
from vrenderer_tpu_torch.ops import raster as traster
from vrenderer_tpu_torch.ops import raster_cuda

SUB_H = 16
ATTR_TOL = 3e-4   # tests/test_raster_pallas.py's attribute bound


@pytest.fixture(scope="module")
def view():
    """Both packages' phase 1 and filter on one view, every third (item,
    cell) pair that holds a winner turned off (JAX: its round count set to
    0; the port: its live byte cleared; items map one to one through JAX's
    real-item prefix), and JAX's resolve of what is left."""
    inst, vout, setup, vc = _scene(*_VIEWS["frontal"])
    packed = raster_pallas.pack_tri_data(setup, I, T, tri_batch=64)
    work = _jax_work(inst, vout, vc, packed, SUB_H)
    kw = dict(tile=128, sub_h=SUB_H, compact_k=16, max_work=MAX_WORK,
              interpret=True)
    z_pad, id_pad = raster_pallas.rasterize_pallas_zid(packed, work, W, H,
                                                       **kw)
    # uncovered pixels hold stale ids in JAX's phase 1 (ROADMAP section C)
    id_pad = np.where(np.asarray(z_pad) == raster_cuda.F32_FAR, BIG_ID,
                      np.asarray(id_pad))
    jwork2 = raster_pallas.filter_work_to_winners(work, id_pad, T, W, H,
                                                  tile=128, sub_h=SUB_H)

    tpacked = raster_cuda.pack_setup(traster.TriSetup(*(t(x) for x in setup)),
                                     I)
    twork = _port_work(inst, vout, vc, MAX_WORK)
    single = raster_cuda.rasterize(tpacked, twork, W, H)
    ids = single[1]
    twork2, live = raster_cuda.filter_work_to_winners(twork, ids, T, W, H)

    # the (slot, cell) of every covered pixel's winner
    items = twork.items.numpy()
    jslot = np.nonzero(np.asarray(work.meta)[5] == 1)[0]
    slot_of = {(int(i), int(s)): k
               for k, (i, s) in enumerate(items) if i >= 0}
    idn = ids.numpy()
    y, x = np.nonzero(idn >= 0)
    st = (y // 128) * (-(-W // 128)) + x // 128
    k = np.array([slot_of[(int(i), int(s))]
                  for i, s in zip(idn[y, x] // T, st)])
    c = (y % 128) // SUB_H
    pairs = sorted(set(zip(k.tolist(), c.tolist())))
    off = pairs[::3]
    live_off = live.clone()
    rounds = np.asarray(jwork2.sub_rounds).copy()
    for ks, cs in off:
        live_off[ks, cs] = False
        rounds[cs, jslot[ks]] = 0
    jattr = raster_pallas.rasterize_pallas_resolve(
        packed, jwork2._replace(sub_rounds=jnp.asarray(rounds)),
        jnp.asarray(id_pad), W, H, **kw)
    off_set = set(off)
    off_px = np.zeros((H, W), bool)
    off_px[y, x] = [(a, b) in off_set for a, b in zip(k.tolist(), c.tolist())]
    return dict(tpacked=tpacked, twork=twork, twork2=twork2, ids=ids,
                live=live, live_off=live_off, single=single, off=off,
                off_px=off_px, slot_pc=(k, c, y, x),
                jattrs=np.moveaxis(np.asarray(jattr)[:, :H, :W], 0, -1))


def test_resolve_matches_pallas_resolve_with_dead_pairs(view):
    """Zeros at the pixels of the turned-off pairs in both packages; the
    JAX values within 3e-4 elsewhere; the port bitwise equal to B1 where
    live."""
    attrs = raster_cuda.rasterize_resolve(
        view["tpacked"], view["twork2"], view["live_off"], view["ids"], W, H)
    a, ja = attrs.numpy(), view["jattrs"]
    off, cov = view["off_px"], view["ids"].numpy() >= 0
    assert off.sum() > 500 and (cov & ~off).sum() > 5000
    assert np.all(a[off] == 0.0) and np.all(ja[off] == 0.0)
    assert np.all(a[~cov] == 0.0)
    keep = cov & ~off
    np.testing.assert_allclose(a[keep], ja[keep], rtol=0, atol=ATTR_TOL)
    np.testing.assert_array_equal(a[keep], view["single"][2].numpy()[keep])


def test_resolve_writes_where_any_copy_is_live(view):
    """An item listed twice: its pixels are written at a cell where either
    copy is live, and zeroed only where neither is."""
    items = view["twork2"].items.clone()
    live = view["live_off"].clone()
    spare = np.nonzero(items[:, 0].numpy() < 0)[0]
    k, c, y, x = view["slot_pc"]
    # (a) a copy live at the turned-off cells of slot ks revives them;
    # (b) a copy with no live cell takes nothing from slot kd
    ks = view["off"][0][0]
    kd = next(kk for kk, cc in view["off"] if kk != ks)
    items[spare[0]], live[spare[0]] = items[ks], ~live[ks]
    items[spare[1]], live[spare[1]] = items[kd], False
    work = raster_cuda.WorkList(items=items,
                                num_items=view["twork2"].num_items)
    attrs = raster_cuda.rasterize_resolve(view["tpacked"], work, live,
                                          view["ids"], W, H).numpy()
    b1 = view["single"][2].numpy()
    revived = np.zeros((H, W), bool)
    revived[y[k == ks], x[k == ks]] = True
    want = (view["ids"].numpy() >= 0) & (~view["off_px"] | revived)
    assert revived.sum() > 0 and (view["off_px"] & ~revived).sum() > 0
    np.testing.assert_array_equal(attrs[want], b1[want])
    assert np.all(attrs[~want] == 0.0)


@pytest.mark.parametrize("sub_h,win_w", [(16, 128), (8, 64)])
def test_filter_dispatch_equals_plain_on_cpu(view, sub_h, win_w):
    """CPU tensors run the plain filter: same work list and live mask, no
    launch counted."""
    before = raster_cuda.filter_work_to_winners.launches
    args = (view["twork"], view["ids"], T, W, H, 128, sub_h, win_w)
    work2, live = raster_cuda.filter_work_to_winners(*args)
    wp, lp = raster_cuda.filter_work_to_winners_plain(*args)
    assert torch.equal(work2.items, wp.items) and torch.equal(live, lp)
    assert int(work2.num_items) == int(view["twork"].num_items)
    assert live.any() and not live.all()
    assert raster_cuda.filter_work_to_winners.launches == before

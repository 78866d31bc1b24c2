"""The port's guide cache against the JAX package's, on the CPU.

ResNet-18 guides of 96-px images (as ``tests/test_visual_e2e.py``), both
caches reading the same pixel rows: host guides agree to 1e-4 of their
largest magnitude (fp32 convs summed in other orders by the two
libraries).  The device table gives exactly the bf16 rounding of the host
guides.  Host LRU eviction, the disk spill, table-row reuse and the
accum-shaped gather are held against the JAX cache's bookkeeping.
"""

import os

import numpy as np
import pytest
import torch

import jax

from mtvaf_tpu.nn.resnet import init_resnet_params
from mtvaf_tpu.train.ingest import GuideCache as JaxGuideCache
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.images import ImageStore
from mtvaf_tpu_torch.data.synthetic import make_images
from mtvaf_tpu_torch.train.ingest import GuideCache

IDS = [f"{800000 + i}.jpg" for i in range(5)]


class JaxStoreView:
    """The port's ``ImageStore`` as the JAX guide cache calls it: that
    cache asks for the aux crops by keyword."""

    def __init__(self, store):
        self._store = store

    def __getattr__(self, name):
        return getattr(self._store, name)

    def batch(self, image_ids, with_aux=True):
        assert with_aux
        return self._store.batch(image_ids)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("ingest")
    make_images(str(d / "imgs"), IDS, size=96, seed=3)
    make_images(str(d / "aux"), ["c0.jpg", "c1.jpg"], size=96, seed=4)
    store = ImageStore(str(d / "imgs"), str(d / "aux"),
                       aux_map={IDS[0]: ["c0.jpg", "c1.jpg"],
                                IDS[2]: ["c1.jpg"]})
    jparams = jax.tree.map(np.asarray,
                           init_resnet_params(jax.random.PRNGKey(1), 18))
    jcache = JaxGuideCache(jparams, 18, device_items=0)
    want = jcache.batch(IDS, JaxStoreView(store))
    return d, store, jparams, [np.asarray(w) for w in want]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_host_guides_match_jax(setup):
    d, store, jparams, (want_main, want_aux) = setup
    cache = GuideCache(params_from_jax(jparams), 18, device="cpu")
    main, aux = cache.batch(IDS, store)
    assert isinstance(main, np.ndarray) and main.dtype == np.float32
    assert main.shape == (5, 4, 960) and aux.shape == (5, 3, 4, 960)
    _close(main, want_main)
    _close(aux, want_aux)
    assert cache.computed == 5
    # repeated ids: served from the host cache, no new ResNet call
    again, _ = cache.batch([IDS[1], IDS[1], IDS[4]], store)
    assert cache.computed == 5
    np.testing.assert_array_equal(again[0], again[1])
    np.testing.assert_array_equal(again[2], main[4])


def test_device_table_is_the_bf16_rounding_of_the_host_path(setup):
    d, store, jparams, _ = setup
    resnet = params_from_jax(jparams)
    host = GuideCache(resnet, 18, device="cpu")
    hm, ha = host.batch(IDS, store)
    table = GuideCache(resnet, 18, device_items=8, device="cpu")
    dm, da = table.batch(IDS, store)
    assert isinstance(dm, torch.Tensor) and dm.dtype == torch.bfloat16
    assert torch.equal(dm, torch.from_numpy(hm).to(torch.bfloat16))
    assert torch.equal(da, torch.from_numpy(ha).to(torch.bfloat16))
    # accum-shaped gather: (accum, B/accum, ...) in batch order
    ids = [IDS[3], IDS[0], IDS[0], IDS[4]]
    am, aa = table.batch(ids, store, accum=2)
    assert am.shape == (2, 2, 4, 960) and aa.shape == (2, 2, 3, 4, 960)
    flat, _ = host.batch(ids, store)
    assert torch.equal(am.reshape(4, 4, 960),
                       torch.from_numpy(flat).to(torch.bfloat16))


def test_table_row_reuse_and_fallback_follow_jax(setup):
    d, store, jparams, _ = setup
    table = GuideCache(params_from_jax(jparams), 18, device_items=2,
                       device="cpu")
    jtable = JaxGuideCache(jparams, 18, device_items=2)
    host = GuideCache(params_from_jax(jparams), 18, device="cpu")
    for batch in ([IDS[0]], [IDS[1]], [IDS[0]], [IDS[2]], [IDS[3], IDS[3]]):
        got, _ = table.batch(batch, store)
        jtable.batch(batch, JaxStoreView(store))
        assert list(table._dev_rows.items()) == [
            ((k[0], k[1]), r) for k, r in jtable._dev_rows.items()]
        want, _ = host.batch(batch, store)
        assert torch.equal(got, torch.from_numpy(want).to(torch.bfloat16))
    # more images than rows: host fp32 guides, as the JAX cache returns
    got, _ = table.batch(IDS[:3], store)
    jgot, _ = jtable.batch(IDS[:3], JaxStoreView(store))
    assert isinstance(got, np.ndarray) and isinstance(jgot, np.ndarray)
    np.testing.assert_array_equal(got, host.batch(IDS[:3], store)[0])


def test_host_lru_spills_to_disk_and_reloads(setup, tmp_path):
    d, store, jparams, _ = setup
    cache = GuideCache(params_from_jax(jparams), 18, max_items=2,
                       cache_dir=str(tmp_path / "g"), device="cpu")
    jcache = JaxGuideCache(jparams, 18, max_items=2,
                           cache_dir=str(tmp_path / "jg"))
    first, _ = cache.batch(IDS[:4], store)
    jcache.batch(IDS[:4], JaxStoreView(store))
    assert list(cache._cache) == list(jcache._cache)
    assert sorted(os.listdir(tmp_path / "g")) \
        == sorted(os.listdir(tmp_path / "jg"))
    assert len(os.listdir(tmp_path / "g")) == 2
    # an evicted image comes back from its .npz, not from the ResNet
    n = cache.computed
    again, _ = cache.batch([IDS[0]], store)
    assert cache.computed == n
    np.testing.assert_array_equal(again[0], first[0])

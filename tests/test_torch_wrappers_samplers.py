"""The port's dataset wrappers and samplers (``datasets/wrappers.py``,
``datasets/samplers.py``, ``build_dataloader``'s sampler branches) against
the JAX package's: the cases of ``tests/test_wrappers_samplers.py``, each
run through both classes on the same toy dataset.  Lengths, items and the
index streams (several epochs and seeds) are equal."""
import numpy as np
import pytest

import deep3dmap_tpu.datasets.samplers as jax_samp
from deep3dmap_tpu.datasets import builder as jax_builder
from deep3dmap_tpu.datasets import wrappers as jax_wrap
from deep3dmap_tpu_torch.datasets import builder, samplers, wrappers


class _Toy:
    CLASSES = ("a", "b")

    def __init__(self, n=10, flag_split=5):
        self.n = n
        flag_split = min(flag_split, n)
        self.flag = np.array([0] * flag_split + [1] * (n - flag_split), dtype=np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return dict(img=np.full((2, 2), float(idx), np.float32), idx=idx)

    def get_cat_ids(self, idx):
        return [0] if idx % 5 else [1]

    def evaluate(self, results, logger=None, **kw):
        return {"n_results": len(results)}


for _reg in (builder.DATASETS, jax_builder.DATASETS):
    _reg.register_module(name="_WrapToy", module=_Toy, force=True)


def _items(ds):
    return [(int(ds[i]["idx"]), ds[i]["img"].tolist()) for i in range(len(ds))]


def _both(make):
    return make(jax_wrap), make(wrappers)


def test_concat_dataset():
    j, t = _both(lambda m: m.ConcatDataset([_Toy(4), _Toy(6)]))
    assert len(t) == len(j) == 10 and _items(t) == _items(j)
    assert t[-1]["idx"] == j[-1]["idx"] == 5
    assert t.evaluate(list(range(10))) == j.evaluate(list(range(10))) \
        == {"0_n_results": 4, "1_n_results": 6}
    np.testing.assert_array_equal(t.flag, j.flag)
    jj, tt = _both(lambda m: m.ConcatDataset([_Toy(4), _Toy(6)], separate_eval=False))
    assert tt.evaluate(list(range(10))) == jj.evaluate(list(range(10))) == {"n_results": 10}


def test_repeat_dataset():
    j, t = _both(lambda m: m.RepeatDataset(_Toy(4), times=3))
    assert len(t) == len(j) == 12 and _items(t) == _items(j)
    assert t.get_cat_ids(5) == j.get_cat_ids(5) == t.dataset.get_cat_ids(1)
    np.testing.assert_array_equal(t.flag, j.flag)


def test_class_balanced_dataset():
    j, t = _both(lambda m: m.ClassBalancedDataset(_Toy(10), oversample_thr=0.8))
    assert t.repeat_indices == j.repeat_indices and len(t) == len(j) == 12
    assert _items(t) == _items(j)
    np.testing.assert_array_equal(t.flag, j.flag)


def test_multi_image_mix_dataset():
    class _Mix:
        def get_indexes(self, dataset):
            return [1, 2]

        def __call__(self, results):
            results["mixed"] = sum(r["idx"] for r in results["mix_results"])
            return results

    j, t = _both(lambda m: m.MultiImageMixDataset(_Toy(5), pipeline=[_Mix()]))
    assert t[0]["mixed"] == j[0]["mixed"] == 3 and "mix_results" not in t[0]
    assert len(t) == len(j) == 5
    skip = wrappers.MultiImageMixDataset(_Toy(5), pipeline=[_Mix()], skip_type_keys=["_Mix"])
    assert "mixed" not in skip[0]
    # a pipeline the port's registry does not hold fails there, as in JAX
    with pytest.raises(KeyError):
        wrappers.MultiImageMixDataset(_Toy(5), pipeline=[dict(type="Mosaic")])


@pytest.mark.parametrize("cfg", [
    dict(type="RepeatDataset", times=2, dataset=dict(type="_WrapToy", n=3)),
    dict(type="ConcatDataset", datasets=[dict(type="_WrapToy", n=3), dict(type="_WrapToy", n=4)]),
    dict(type="ClassBalancedDataset", oversample_thr=0.8, dataset=dict(type="_WrapToy", n=10)),
    [dict(type="_WrapToy", n=2), dict(type="_WrapToy", n=5)],
], ids=["repeat", "concat", "class_balanced", "list"])
def test_build_dataset_wrapper_dispatch(cfg):
    j, t = jax_builder.build_dataset(cfg), builder.build_dataset(cfg)
    assert type(t).__name__ == type(j).__name__ and len(t) == len(j)
    assert _items(t) == _items(j)


def _streams(sampler_cls, epochs=3, **kw):
    out = []
    for epoch in range(epochs):
        s = sampler_cls(**kw)
        s.set_epoch(epoch)
        out.append(list(iter(s)))
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_group_sampler_stream(seed):
    ds = _Toy(n=10, flag_split=6)
    t = _streams(samplers.GroupSampler, dataset=ds, samples_per_gpu=2, seed=seed)
    assert t == _streams(jax_samp.GroupSampler, dataset=ds, samples_per_gpu=2, seed=seed)
    for idx in t:
        for b in range(0, len(idx), 2):
            assert ds.flag[idx[b]] == ds.flag[idx[b + 1]]


@pytest.mark.parametrize("shuffle", [True, False])
def test_distributed_sampler_streams(shuffle):
    ds = _Toy(n=10)
    parts = []
    for rank in range(4):
        kw = dict(dataset=ds, num_replicas=4, rank=rank, shuffle=shuffle, seed=3)
        t = _streams(samplers.DistributedSampler, **kw)
        assert t == _streams(jax_samp.DistributedSampler, **kw)
        parts.append(t[0])
    assert all(len(p) == 3 for p in parts)
    assert set(np.concatenate(parts)) == set(range(10))


def test_distributed_group_sampler_streams():
    ds = _Toy(n=10, flag_split=6)
    seen = []
    for rank in range(2):
        kw = dict(dataset=ds, samples_per_gpu=2, num_replicas=2, rank=rank, seed=1)
        t = _streams(samplers.DistributedGroupSampler, **kw)
        assert t == _streams(jax_samp.DistributedGroupSampler, **kw)
        seen.extend(t[0])
    assert set(seen) == set(range(10))


def test_distributed_video_sampler():
    ds = _Toy(n=9)
    ds.data_infos = [dict(frame_id=i % 3) for i in range(9)]
    t = [list(iter(samplers.DistributedVideoSampler(ds, num_replicas=3, rank=r)))
         for r in range(3)]
    j = [list(iter(jax_samp.DistributedVideoSampler(ds, num_replicas=3, rank=r)))
         for r in range(3)]
    assert t == j == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    with pytest.raises(ValueError, match="videos loaded"):
        samplers.DistributedVideoSampler(ds, num_replicas=4, rank=0)


def test_dist_info_without_torch_distributed():
    assert samplers.get_dist_info() == (0, 1)
    assert samplers.DistributedSampler(_Toy(6)).num_replicas == 1


def _loader_idx(loader, epochs=2):
    return [[b["idx"].tolist() for b in loader] for _ in range(epochs)]


def test_build_dataloader_group_aware():
    ds = _Toy(n=8, flag_split=4)
    t = builder.build_dataloader(ds, samples_per_gpu=2, shuffle=True, seed=5)
    j = jax_builder.build_dataloader(ds, samples_per_gpu=2, shuffle=True, seed=5)
    assert isinstance(t.sampler, samplers.GroupSampler) and len(t) == len(j) == 4
    assert _loader_idx(t) == _loader_idx(j)
    for b in t:
        assert ds.flag[b["idx"][0]] == ds.flag[b["idx"][1]]


@pytest.mark.parametrize("shuffle,flag_split", [(False, 8), (True, 4)],
                         ids=["distributed", "distributed_group"])
def test_build_dataloader_dist_slices(monkeypatch, shuffle, flag_split):
    ds = _Toy(n=8, flag_split=flag_split)
    seen = []
    for rank in range(2):
        monkeypatch.setattr(samplers, "get_dist_info", lambda: (rank, 2))
        monkeypatch.setattr(jax_samp, "get_dist_info", lambda: (rank, 2))
        t = builder.build_dataloader(ds, samples_per_gpu=2, dist=True, shuffle=shuffle)
        j = jax_builder.build_dataloader(ds, samples_per_gpu=2, dist=True, shuffle=shuffle)
        assert type(t.sampler).__name__ == type(j.sampler).__name__
        assert _loader_idx(t) == _loader_idx(j)
        seen.extend(i for b in _loader_idx(t, 1)[0] for i in b)
    assert sorted(seen) == list(range(8))

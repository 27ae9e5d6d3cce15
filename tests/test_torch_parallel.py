"""The port's data-parallel tier in one process, against the JAX package.

``parallel/mesh.py shard_index_space`` and the per-host shards of
``data/loader.py batch_iterator`` and ``data/odgt.py``'s pipelines equal
the JAX package's, index for index and record for record (PIL resampling
on both sides, so batches are bit-equal); the profiler hooks write a trace
that names an annotated region; the collectives are identities without a
process group, and the distributed checkpoint round-trips in one process.
The multi-rank side runs in ``tests/test_torch_ddp.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.data import loader as jloader
from open_world_semantic_segmentation_tpu.data.odgt import (
    TrainPipeline as JaxTrainPipeline, ValPipeline as JaxValPipeline)
from open_world_semantic_segmentation_tpu.parallel import (
    shard_index_space as jax_shard_index_space)
from open_world_semantic_segmentation_tpu_torch.data import loader
from open_world_semantic_segmentation_tpu_torch.data.odgt import (
    TrainPipeline, ValPipeline)
from open_world_semantic_segmentation_tpu_torch.parallel import mesh
from open_world_semantic_segmentation_tpu_torch.parallel import (
    all_reduce_sum, data_group, init_distributed, replicas_agree, replicate,
    shard_index_space, world_size)
from open_world_semantic_segmentation_tpu_torch.train.checkpoint import (
    load_checkpoint_distributed, save_checkpoint_distributed)
from open_world_semantic_segmentation_tpu_torch.utils.observability import (
    TRACE_FILE, annotate, profile_trace)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS = 4


@pytest.mark.parametrize("num_samples,num_hosts", [(103, 4), (100, 4),
                                                   (7, 3), (5, 8), (1, 1)])
@pytest.mark.parametrize("seed", [None, 7])
def test_shard_index_space_matches_jax(num_samples, num_hosts, seed):
    for host in range(num_hosts):
        got = shard_index_space(num_samples, num_hosts, host,
                                shuffle_seed=seed)
        want = jax_shard_index_space(num_samples, num_hosts, host,
                                     shuffle_seed=seed)
        np.testing.assert_array_equal(got, want)


class _Range:
    """A dataset of (i, 2i, -i) samples."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return (np.array(i), np.array(2 * i), np.array(-i))


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_host_shards_match_jax(shuffle):
    seen = []
    for host in range(HOSTS):
        kw = dict(shuffle=shuffle, seed=5, drop_last=False, epochs=2,
                  num_workers=0, num_hosts=HOSTS, host_id=host)
        got = list(loader.batch_iterator(_Range(), 2, **kw))
        want = list(jloader.batch_iterator(_Range(), 2, **kw))
        assert len(got) == len(want) == 4        # 3 samples a host, 2 epochs
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        seen += [int(i) for batch in got[:2] for i in batch[0]]
    # an epoch's shards cover the dataset (padding repeats the first one)
    assert set(seen) == set(range(11)) and len(seen) == 12


@pytest.fixture(scope="module")
def street_tree(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synthetic_data import make_streethazards

    return make_streethazards(str(tmp_path_factory.mktemp("sh")),
                              n_train=7, n_val=5, h=40, w=56, seed=3)


def test_train_pipeline_host_shards_match_jax(street_tree):
    kw = dict(batch_per_gpu=2, img_sizes=(32, 40), img_max_size=80,
              padding_constant=8, segm_downsampling_rate=8, seed=11,
              use_native=False, num_hosts=HOSTS)
    odgt = os.path.join(street_tree, "train.odgt")
    records = []
    for host in range(HOSTS):
        mine = TrainPipeline(street_tree, odgt, host_id=host, **kw)
        theirs = JaxTrainPipeline(street_tree, odgt, host_id=host, **kw)
        assert mine.records == theirs.records
        records += [r["fpath_img"] for r in mine.records]
        for _ in range(3):          # past a reshuffle of the 2 records
            got, want = mine.next_batch(), theirs.next_batch()
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
    assert len(set(records)) == 7 and len(records) == 8


def test_val_pipeline_host_shards_match_jax(street_tree):
    kw = dict(img_sizes=(32, 40), img_max_size=80, padding_constant=8,
              num_hosts=HOSTS)
    odgt = os.path.join(street_tree, "val.odgt")
    for host in range(HOSTS):
        mine = ValPipeline(street_tree, odgt, host_id=host, **kw)
        theirs = JaxValPipeline(street_tree, odgt, host_id=host, **kw)
        assert mine.records == theirs.records and len(mine) == 2
        got, want = mine[0], theirs[0]
        np.testing.assert_array_equal(got["seg_label"], want["seg_label"])
        for a, b in zip(got["img_data"], want["img_data"]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="host_id"):
        ValPipeline(street_tree, odgt, num_hosts=2, host_id=2)


def test_one_process_is_the_identity(monkeypatch):
    """Without a launcher nothing joins a group, and every collective
    helper leaves its input as it is."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed("cpu") == (0, 1, torch.device("cpu"))
    assert data_group() is None and world_size(None) == 1
    x = torch.randn(5, requires_grad=True)
    assert all_reduce_sum(x) is x
    model = torch.nn.Linear(3, 2)
    assert replicate(model) is model
    assert replicas_agree(list(model.parameters()))
    with pytest.raises(ValueError, match="backend"):
        monkeypatch.setenv("WORLD_SIZE", "1")
        init_distributed("cpu", backend="mpi")


@pytest.mark.parametrize("device,local_ranks,cards,want", [
    ("cpu", "4", 0, "gloo"), ("cuda", "2", 2, "nccl"),
    ("cuda", "8", 8, "nccl"), ("cuda", "2", 1, "gloo"),
    ("cuda", None, 1, "nccl")])
def test_backend_is_nccl_only_with_a_card_a_rank(monkeypatch, device,
                                                 local_ranks, cards, want):
    """NCCL refuses two ranks on one device: ranks that share a card, as
    ``torch.distributed.run --nproc_per_node 2`` on one card makes them,
    take gloo; so does the CPU."""
    if local_ranks is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_ranks)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh._default_backend(torch.device(device)) == want


def test_distributed_checkpoint_round_trips_in_one_process(tmp_path):
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                                torch.nn.BatchNorm2d(4))
    model(torch.randn(2, 3, 8, 8, generator=gen))       # moves the stats
    state = {"model": model.state_dict(), "step": 12,
             "extra": {"w": torch.randn(3, 5, dtype=torch.float64,
                                        generator=gen)}}
    save_checkpoint_distributed(str(tmp_path / "ckpt"), state)
    target = {"model": {k: torch.zeros_like(v)
                        for k, v in model.state_dict().items()},
              "step": 0, "extra": {"w": torch.zeros(3, 5,
                                                    dtype=torch.float64)}}
    out = load_checkpoint_distributed(str(tmp_path / "ckpt"), target)
    assert out is target and out["step"] == 12
    for key, value in state["model"].items():
        assert torch.equal(out["model"][key], value), key
    assert torch.equal(out["extra"]["w"], state["extra"]["w"])


def test_profile_trace_names_annotated_regions(tmp_path):
    log_dir = tmp_path / "trace"
    x = torch.randn(16, 16)
    with profile_trace(str(log_dir)) as prof:
        with annotate("owss_region"):
            (x @ x).sum()
    assert prof is not None
    with open(log_dir / TRACE_FILE) as f:
        trace = json.load(f)
    names = [e.get("name") for e in trace["traceEvents"]]
    assert "owss_region" in names and "aten::mm" in names
    # a falsy directory profiles nothing and writes nothing
    with profile_trace(None) as off:
        with annotate("owss_region"):
            x.sum()
    assert off is None and sorted(os.listdir(tmp_path)) == ["trace"]

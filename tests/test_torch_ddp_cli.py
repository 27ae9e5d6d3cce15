"""The two training entry points over 2 gloo ranks on the CPU.

``cli/train_embedding.main`` (resnet18dilated + ppm_deepsup_embedding,
32-pixel images, 2 steps of 2 images a rank) and ``cli/main_deeplab.main``
(deeplabv3plus_mobilenet, crop 32, 2 steps of 2 a rank, a validation at
the last) run in the same two ranks (``tests/torch_ddp_worker.py cli``),
as ``torch.distributed.run`` would start them, each rank taking its shard
of the records. Every rank reports the global loss of each step, so the
ranks' losses are equal; only rank 0 prints, writes ``metrics.jsonl`` and
the checkpoints, and validates; both mains end by checking that the
ranks' weights are bit-identical. Without ``WORLD_SIZE`` the mains run as
before (``tests/test_torch_train.py``, ``test_torch_deeplab_train.py``).
"""

import json

from torch_ddp_worker import Ranks


def test_training_entry_points_over_two_ranks(tmp_path):
    job = Ranks("cli", tmp_path, world=2)
    results = job.results()
    logs = [(job.out / f"rank{r}.log").read_text() for r in range(2)]
    for rank, res in enumerate(results):
        for cli in ("embedding", "deeplab"):
            assert res[cli]["rank"] == rank and res[cli]["world"] == 2
            assert res[cli]["steps"] == 2 and res[cli]["skipped"] == 0
    for cli in ("embedding", "deeplab"):
        assert results[0][cli]["losses"] == results[1][cli]["losses"]
    assert results[0]["writes"] == {"embedding": 1, "deeplab": 2}
    assert results[1]["writes"] == {"embedding": 0, "deeplab": 0}
    assert len(results[0]["deeplab"]["validations"]) == 1
    assert results[1]["deeplab"]["validations"] == []
    with open(job.out / "embedding" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    assert logs[0].count("replicas: 2 ranks bit-identical") == 2
    for marker in ("Epoch:", "Itrs", "validation", "replicas"):
        assert marker in logs[0] and marker not in logs[1], marker

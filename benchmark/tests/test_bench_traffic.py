"""The traffic mixes and their generator: one seed, one set of videos;
the sizes of each mix; frames made before the window."""

import hashlib

import numpy as np
import pytest

from benchmark.harness.manifest import HERE, load_json
from benchmark.harness.videos import make_videos, order, render

MIXES = ("davis17val",)


def _digest(videos):
    h = hashlib.sha256()
    for v in videos:
        h.update(v.frames.tobytes())
        for t in sorted(v.labels):
            h.update(v.labels[t].tobytes())
    return h.hexdigest()


def _small(mix):
    return dict(mix, frame_hw=[48, 80], videos=mix["videos"][:4])


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_videos(name):
    mix = _small(load_json(HERE / "traffic" / f"{name}.json"))
    a = make_videos(mix, 2 ** 33 + 1, "cpu", 2)
    b = make_videos(mix, 2 ** 33 + 1, "cpu", 2)
    c = make_videos(mix, 2 ** 33 + 2, "cpu", 2)
    assert _digest(a) == _digest(b) != _digest(c)


def test_every_seed_gets_the_same_set_of_videos():
    mix = load_json(HERE / "traffic" / "davis17val.json")
    for seed in (0, 1, 2 ** 31 + 3, 2 ** 40):
        assert sorted(order(mix, seed)) == list(range(len(mix["videos"])))
    assert order(mix, 1) != order(mix, 2)


def test_davis_sizes():
    mix = load_json(HERE / "traffic" / "davis17val.json")
    frames = [v[0] for v in mix["videos"]]
    objs = [v[1] for v in mix["videos"]]
    assert mix["frame_hw"] == [480, 854] and len(frames) == 30
    assert sum(frames) == 1999 and 34 <= min(frames) and max(frames) <= 104
    assert 1 <= min(objs) and max(objs) <= 5 and 1.8 < np.mean(objs) < 2.3
    assert all(f == 0 for v in mix["videos"] for f in v[2])


def test_frames_are_made_ahead_as_uint8_with_masks_of_their_objects():
    spec = [9, 3, [0, 4, 0]]
    v = render(spec, (48, 80), 5, 0, "cpu", "v")
    assert isinstance(v.frames, np.ndarray) and v.frames.dtype == np.uint8
    assert v.frames.shape == (9, 48, 80, 3)
    assert sorted(v.labels) == [0, 4]
    assert set(np.unique(v.labels[4]).tolist()) <= {0, 2}
    assert 2 not in np.unique(v.labels[0]).tolist()

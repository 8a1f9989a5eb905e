"""Port parity: fiode_tpu_torch.train.data (numpy only) against the JAX
package's data module.  The synthetic set is made from a seed by the same
numpy calls, so every array is equal bit for bit."""
import dataclasses

import numpy as np
import pytest

from fiode_tpu.train import data as jdata
from fiode_tpu_torch.train import data as tdata

FIELDS = ("train_x", "train_y", "val_x", "val_y", "test_x", "test_y")


@pytest.mark.parametrize("hardness", [0.0, 0.5])
@pytest.mark.parametrize("name", ["CIFAR10", "MNIST", "CIFAR3"])
def test_synthetic_set_is_bit_identical(name, hardness, tmp_path):
    kw = dict(data_root=str(tmp_path), seed=0, synthetic_size=256,
              synthetic_hardness=hardness)
    want = jdata.load_dataset(name, **kw)
    got = tdata.load_dataset(name, **kw)
    assert got.synthetic and want.synthetic
    assert got.n_classes == want.n_classes and got.name == want.name
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert got.image_shape == want.image_shape


def test_certification_test_set_is_the_artifacts(tmp_path):
    # the committed certification artifacts are on this set: seed 0, 512
    # test images of the default synthetic size
    got = tdata.load_dataset("CIFAR10", str(tmp_path))
    want = jdata.load_dataset("CIFAR10", str(tmp_path))
    assert got.test_x.shape == (512, 3, 32, 32)
    assert got.test_x.tobytes() == want.test_x.tobytes()
    assert got.test_y.tobytes() == want.test_y.tobytes()


def test_dataset_info_and_fields_equal():
    assert tdata.DATASET_INFO == jdata.DATASET_INFO
    assert ([f.name for f in dataclasses.fields(tdata.Dataset)]
            == [f.name for f in dataclasses.fields(jdata.Dataset)])


def test_readers_read_what_the_jax_readers_read(tmp_path):
    # a CIFAR-10 binary drop-in, 20 images a batch
    rng = np.random.default_rng(0)
    bindir = tmp_path / "cifar-10-batches-bin"
    bindir.mkdir()
    for fname in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        raw = rng.integers(0, 256, size=(20, 3073), dtype=np.uint8)
        raw[:, 0] = rng.integers(0, 10, size=20)
        raw.tofile(bindir / fname)
    got = tdata.load_dataset("CIFAR10", str(tmp_path), allow_synthetic=False)
    want = jdata.load_dataset("CIFAR10", str(tmp_path), allow_synthetic=False)
    assert not got.synthetic and len(got.train_x) == 100
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    report, jreport = (m.check_data_root("CIFAR10", str(tmp_path))
                       for m in (tdata, jdata))
    assert report["ok"] == jreport["ok"] is False  # 100 images are not CIFAR-10
    assert report["sha256_test_x"] == jreport["sha256_test_x"]


def test_missing_files_raise_when_synthetic_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdata.load_dataset("MNIST", str(tmp_path), allow_synthetic=False)
    with pytest.raises(ValueError):
        tdata.load_dataset("SVHN", str(tmp_path))
    assert tdata.check_data_root("MNIST", str(tmp_path))["ok"] is False

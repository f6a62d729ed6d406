"""The port's pretrained-weight fetch (`pddl_tpu_torch/ckpt/fetch.py`)
against the JAX package's `pddl_tpu/ckpt/fetch.py`: the same published
files and hashes, the same cache directory, the same offline error text
for the same cache, the MD5 check on a cached file, the unknown-variant
error, and the opt-in download with `urllib.request.urlretrieve`
replaced (nothing here touches the network)."""

import hashlib

import pytest

import pddl_tpu.ckpt.fetch as jf
import pddl_tpu_torch.ckpt.fetch as tf_
from pddl_tpu_torch.ckpt import fetch_keras_resnet50_weights

NOTOP = "resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5"


def test_tables_and_cache_dir_equal_jax(tmp_path, monkeypatch):
    assert tf_.KERAS_RESNET_WEIGHTS == jf.KERAS_RESNET_WEIGHTS
    assert tf_.BASE_WEIGHTS_URL == jf.BASE_WEIGHTS_URL
    assert tf_.default_cache_dir() == jf.default_cache_dir()
    monkeypatch.setenv("PDDL_TPU_CACHE", str(tmp_path))
    assert tf_.default_cache_dir() == jf.default_cache_dir() == str(
        tmp_path / "keras")


@pytest.mark.parametrize("variant,model", [("notop", "resnet50"),
                                           ("top", "resnet101")])
def test_offline_error_is_the_jax_text(tmp_path, monkeypatch, variant,
                                       model):
    monkeypatch.setenv("PDDL_TPU_CACHE", str(tmp_path))
    errors = []
    for fetch in (fetch_keras_resnet50_weights,
                  jf.fetch_keras_resnet50_weights):
        with pytest.raises(FileNotFoundError) as info:
            fetch(variant, model=model)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    name, md5 = tf_.KERAS_RESNET_WEIGHTS[model][variant]
    assert "curl -fL --create-dirs" in errors[0]
    assert str(tmp_path / "keras" / name) in errors[0]
    assert md5 in errors[0]


def test_cached_file_is_verified(tmp_path, monkeypatch):
    payload = b"pretend-weights"
    (tmp_path / NOTOP).write_bytes(payload)
    with pytest.raises(ValueError, match="MD5 mismatch"):
        fetch_keras_resnet50_weights(cache_dir=str(tmp_path))
    assert fetch_keras_resnet50_weights(
        cache_dir=str(tmp_path), verify=False) == str(tmp_path / NOTOP)
    monkeypatch.setitem(tf_.KERAS_RESNET_WEIGHTS["resnet50"], "notop",
                        (NOTOP, hashlib.md5(payload).hexdigest()))
    assert fetch_keras_resnet50_weights(cache_dir=str(tmp_path)) == str(
        tmp_path / NOTOP)


def test_unknown_variant_raises_the_jax_text():
    for kw in (dict(variant="bottom"), dict(model="resnet34")):
        errors = []
        for fetch in (fetch_keras_resnet50_weights,
                      jf.fetch_keras_resnet50_weights):
            with pytest.raises(ValueError, match="unknown weights") as info:
                fetch(**kw)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


def test_download_opt_in_with_urlretrieve_replaced(tmp_path, monkeypatch):
    payload = b"downloaded-weights"
    monkeypatch.setitem(tf_.KERAS_RESNET_WEIGHTS["resnet50"], "notop",
                        (NOTOP, hashlib.md5(payload).hexdigest()))
    fetched = []

    def fake_urlretrieve(url, dst):
        fetched.append(url)
        with open(dst, "wb") as f:
            f.write(payload)

    monkeypatch.setattr("urllib.request.urlretrieve", fake_urlretrieve)
    path = fetch_keras_resnet50_weights(cache_dir=str(tmp_path / "c"),
                                        download=True)
    assert path == str(tmp_path / "c" / NOTOP)
    assert (tmp_path / "c" / NOTOP).read_bytes() == payload
    assert fetched == [tf_.BASE_WEIGHTS_URL + NOTOP]
    assert [p.name for p in (tmp_path / "c").iterdir()] == [NOTOP]
    fetch_keras_resnet50_weights(cache_dir=str(tmp_path / "c"),
                                 download=True)
    assert len(fetched) == 1  # a cache hit fetches nothing

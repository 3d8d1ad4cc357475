"""`python -m rdeic_torch.inference` with every flag of the root CLI on the
CPU: `--sampler ddim --guidance_scale 2.0 --bf16 --show_lq` on a micro config
and a flat .npz of JAX params. The flags reach the pipeline: the CLI's image
and stream are those of `process()` on a bf16 model with the same sampler,
guidance and seed, and differ from the default flags' image."""
import numpy as np
import pytest
import torch

from rdeic_torch import inference as t_inference
from rdeic_torch.utils.image import pad, to_float01
from tests.torch_port_helpers import MICRO, micro_pair, random_flat_params

FLAGS = ["--sampler", "ddim", "--guidance_scale", "2.0", "--bf16", "--show_lq"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    yaml = pytest.importorskip("yaml")
    from PIL import Image

    tmp = tmp_path_factory.mktemp("serve")
    jm, _, _ = micro_pair(seed=2)
    np.savez(tmp / "p.npz", **random_flat_params(jm, (64, 64), seed=2))
    (tmp / "m.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    arr = np.random.default_rng(3).integers(0, 256, (49, 77, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp / "photo.png")
    return tmp, arr


def _run(tmp, out: str, flags) -> tuple[np.ndarray, bytes]:
    from PIL import Image

    t_inference.main(["--ckpt", str(tmp / "p.npz"), "--config",
                      str(tmp / "m.yaml"), "--input", str(tmp / "photo.png"),
                      "--output", str(tmp / out), "--device", "cpu", *flags])
    return (np.array(Image.open(tmp / out / "photo.png")),
            (tmp / out / "bitstreams" / "photo.rdeic").read_bytes())


def test_cli_runs_every_flag_on_cpu(files):
    tmp, arr = files
    img, stream = _run(tmp, "flags", FLAGS)
    assert img.shape == (49, 77, 3)

    model = t_inference.load_model(str(tmp / "m.yaml"), str(tmp / "p.npz"),
                                   torch.device("cpu"))
    model.set_compute_dtype(torch.bfloat16)
    gen = torch.Generator().manual_seed(231)  # the CLI's default --seed
    img01 = torch.from_numpy(to_float01(pad(arr, 64))[None])
    want, _ = t_inference.process(model, img01, 2, str(tmp / "want.rdeic"),
                                  gen, "ddim", 2.0)
    np.testing.assert_array_equal(img, want[:49, :77])
    assert stream == (tmp / "want.rdeic").read_bytes()

    default, _ = _run(tmp, "default", [])
    assert not np.array_equal(img, default)

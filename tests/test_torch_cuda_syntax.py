"""Every CUDA source of the port parses as C++17 against stub CUDA headers
(``paddle_tpu_torch.tools.cuda_syntax``): g++ instantiates each template
instance its C entry names, so an undeclared or redeclared name, a wrong
argument or a template argument that does not fit fails here, on the
CPU, before a build on the card.  PTX, launch configurations and device
limits are nvcc's and ptxas's to check (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import pytest

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.tools import cuda_syntax


@pytest.mark.parametrize("name", _build.sources())
def test_source_parses(tmp_path, name):
    (tmp_path / "stub").mkdir()
    for header, text in cuda_syntax.STUBS.items():
        (tmp_path / "stub" / header).write_text(text)
    for header in _build.CSRC.glob("*.cuh"):
        (tmp_path / header.name).write_bytes(header.read_bytes())
    ok, log = cuda_syntax.check(name, tmp_path)
    assert ok, log

"""The kernel libraries' build names: a library's hash covers the headers
its sources include, so an edited header never loads a stale build."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402


def test_local_headers_follow_quoted_includes(tmp_path):
    (tmp_path / "inc").mkdir()
    (tmp_path / "inc" / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text('#include "a.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda.h>\n  #  include "inc/a.cuh"\n')
    assert _build.local_headers([src]) == [
        (tmp_path / "inc" / "a.cuh").resolve(),
        (tmp_path / "inc" / "b.cuh").resolve()]


def test_an_edited_header_renames_the_library(tmp_path):
    hdr = tmp_path / "h.cuh"
    hdr.write_text("// one\n")
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    before = _build.library_path("k", [src])
    assert before == _build.library_path("k", [src])
    hdr.write_text("// two\n")
    assert _build.library_path("k", [src]) != before


@pytest.mark.parametrize("ops", [flash_ops, gmm_ops],
                         ids=["flash_attention", "moe_gmm"])
def test_tensor_core_sources_hash_the_shared_header(ops):
    shared = (_build.REPO_ROOT / "src" / "repro_torch" / "kernels"
              / "hopper.cuh").resolve()
    assert shared in _build.local_headers([ops.SOURCE])

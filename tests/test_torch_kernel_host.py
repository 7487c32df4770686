"""Host-side helpers of the port's CUDA kernels, on the CPU.

The kernels themselves run only on a card (tests/test_torch_cuda_kernels.py);
what their wrappers and the build decide on the host is plain Python and
is held here: which page sizes the bf16 path of the paged multi-token
kernel (K3) takes, and how the build's ``ptxas -v`` log is attributed to
entry functions.
"""

import pytest

from vgate_tpu_torch.ops.kernels import _build, paged_multitok

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z6kernelILi256EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi256EEvv
    24 bytes stack frame, 24 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


def test_ptxas_lines_sit_under_their_entry():
    entries = _build.ptxas_entries(PTXAS_LOG)
    assert [e for e, _ in entries] == ["_Z6kernelILi128EEvv"] * 2 + [
        "_Z6kernelILi256EEvv"] * 2
    assert "0 bytes spill stores" in entries[0][1]
    assert "Used 168 registers" in entries[1][1]
    assert "24 bytes spill stores" in entries[2][1]
    assert _build.ptxas_entries("ptxas info    : 0 bytes gmem\n") == []


@pytest.mark.parametrize("hd,key_tile", [(64, 128), (128, 128), (256, 64)])
def test_key_tile_follows_the_head_dim(hd, key_tile):
    assert paged_multitok.key_tile(hd) == key_tile


@pytest.mark.parametrize("ps,hd,takes", [
    (16, 128, True), (32, 128, True), (8, 128, True), (128, 128, True),
    (256, 128, True), (16, 256, True), (32, 256, True), (64, 256, True),
    (128, 256, True), (4, 128, False), (24, 128, False), (48, 256, False),
    (96, 128, False),
])
def test_bf16_path_page_sizes(ps, hd, takes):
    """A key tile is whole TMA boxes of min(ps, kN) rows of one page."""
    assert paged_multitok.tma_page_size(ps, hd) is takes

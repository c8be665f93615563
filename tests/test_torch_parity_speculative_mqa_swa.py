"""The speculative axis of the parity matrix on the port, for the
multi-query and sliding-window flavours: the gate of
``test_torch_parity_speculative.py`` (speculation on equals off, real,
page-native, leak-free, and equal to the reference's serve), split off so
that each file's JAX compilations stay short."""
import pytest

from test_torch_parity_speculative import MODES, check_speculative_cell


@pytest.mark.parametrize("arch", ["mqa", "swa"])
@pytest.mark.parametrize("mode", MODES)
def test_speculative_vs_plain_token_parity(mode, arch):
    check_speculative_cell(arch, mode)

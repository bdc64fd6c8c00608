"""``repro_torch.launch.dryrun.run_cell`` against the reference's in every
cell of the MoE and recurrent architectures (Jamba-1.5 at one pattern
unit of 8 layers, OLMoE, Phi-3.5-MoE, xLSTM-1.3B at 2 layers), on 2 x 2 at
published widths (``dryrun_cells``): the output bytes the reference's
less 8 bytes a leaf of its output tuple in every cell, and in the cells
no other file pins (``dryrun_cells.PINNED``) the per-device argument
bytes exactly the reference's (an argument no op of the step uses is not
counted, as the reference's jit prunes it: Jamba's prefill overwrites its
conv tails without reading them); FLOPs and wire bytes by kind printed
beside the reference's. The depth cut runs every cell directly, Jamba's
``long_500k`` and xLSTM's recurrent cells included: no extrapolation."""

import pytest

import dryrun_cells as dc
from repro_torch import configs

ARCHS = ("jamba_1_5_large", "olmoe_1b_7b", "phi3_5_moe_42b", "xlstm_1_3b")
CELLS = [(a, s.name) for a, s in configs.all_cells() if a in ARCHS]
UNPINNED = [c for c in CELLS if c not in dc.PINNED]


@pytest.fixture(scope="module")
def cells():
    return dc.run_both(CELLS)


@pytest.mark.parametrize("arch,shape", UNPINNED)
def test_run_cell_argument_bytes_are_the_reference(cells, arch, shape):
    dc.check_argument_bytes(cells, arch, shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_output_bytes_are_the_reference_less_its_tuple(cells, arch,
                                                               shape):
    dc.check_output_bytes(cells, arch, shape)

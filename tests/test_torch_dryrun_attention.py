"""``repro_torch.launch.dryrun.run_cell`` against the reference's in every
cell of the pure-attention architectures (Qwen2.5-3B, StableLM-1.6B,
Phi-3-medium-14B, Minitron-8B, InternVL2-1B, HuBERT-xLarge), on 2 x 2 at
published widths, 2 layers (``dryrun_cells``): the output bytes the
reference's less 8 bytes a leaf of its output tuple in every cell, and
in the cells no other file pins (``dryrun_cells.PINNED``) the per-device
argument bytes exactly the reference's (an argument no op of the step
uses is not counted, as the reference's jit prunes it: InternVL2-1B's
prefill reads neither its tokens nor its embedding table, HuBERT-xLarge's
not its labels); FLOPs and wire bytes by kind printed beside the
reference's."""

import pytest

import dryrun_cells as dc
from repro_torch import configs

ARCHS = ("qwen2_5_3b", "stablelm_1_6b", "phi3_medium_14b", "minitron_8b",
         "internvl2_1b", "hubert_xlarge")
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

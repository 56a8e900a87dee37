"""whisper-medium whole (24 + 24 layers) over a (1, 4) mesh, counted on
meta as ``test_torch_tp_counts`` counts the decoder-only models: rank 0's
collectives in one prefill of 4 x 64 tokens over a 1,500-frame window and
in one decode step, and its parameter bytes."""
from test_torch_tp_counts import check_case

WHISPER = (
    ("whisper-medium", {}, (4, 64), 1500),
    {"all_gather": (266, 906816512), "reduce_scatter": (121, 1255669760),
     "broadcast": (1, 8192)},
    {"all_reduce": (217, 2785280), "all_gather": (49, 306176)},
    557621248)


def test_a_whisper_rank_exchanges_and_holds_what_the_chip_phase_predicts():
    check_case(WHISPER)

"""``chip_smoke.py``'s ``[cards]`` expectations held to what the forwards
really run, on the CPU: ``cards_expect`` (the launches and collective calls
a rank makes in one forward of each model in each layout over 4 ranks)
against the calls that ``cards_forward`` makes on 4 gloo ranks with a small
DiT of each kind, and ``cards_request_expect`` against ``cards_expect``;
``cards_i2v_expect`` (the Wan i2v-14B request over tp = 4) against a small
i2v forward cut over 4 ranks and CLIP's ``visual``; ``train_expect`` (the
collective calls of a train step on each mesh of ``[cards]`` (d)) against
a small LTX DiT's step on 4 ranks, its grads in several buckets.

On the CPU a kernel's wrapper launches nothing and counts nothing, so the
rank bodies (``tests/torch_cards_workers.py``) count the calls of the
wrappers through which each kernel launches on the card: ``ops.attention``'s
``flash_attention`` (K1), ``flash_attention_int8`` (K4) and
``flash_attention_hp`` (K6), ``ops.quant``'s ``int8_linear`` (K2) and
``int8_linear_scaled`` (K2s); the models run in bf16, the card's policy,
so that ``auto`` picks the card's route. The collectives are
``parallel/comm.py``'s own counts.
"""

import os
import sys

import pytest

import torch_cards_workers as workers
from ltx_video_gpupoor_tpu_torch.core import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

LAYERS = 2


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    return tmesh.spawn_ranks(
        workers.cards_counts, 4, backend="gloo", timeout=120.0,
        store_dir=str(tmp_path_factory.mktemp("cards")), args=(LAYERS,))


@pytest.mark.parametrize("kind", ["ltx", "wan"])
@pytest.mark.parametrize("layout", sorted(chip_smoke.CARDS_LAYOUTS))
def test_cards_expect_counts_what_a_forward_runs(counted, kind, layout):
    want = chip_smoke.cards_expect(kind, layout, LAYERS)
    for rank, seen in enumerate(counted):
        assert seen[(kind, layout)] == want, (rank, seen[(kind, layout)])


def test_cards_request_expect_is_forwards_of_cards_expect():
    """The Wan request's expectation is its forwards' (one a step: the
    guidance streams are batch rows); the 13B's a pass holds Ulysses' four
    all-to-alls a block a step and two K1 calls a block (under USP the
    self-attention arrives as split heads, as ``test_usp_hp_tier_runs_k1``
    shows), with K2 on every linear (the fused prologue stands aside)."""
    k, c = chip_smoke.cards_request_expect("wan14b", 40, 2)
    k1, c1 = chip_smoke.cards_expect("wan", "tp4", 40)
    assert k == {n: 2 * v for n, v in k1.items()}
    assert c == {"all_to_all": 0, "all_reduce": 2 * c1["all_reduce"]}
    k, c = chip_smoke.cards_request_expect("ltx13b", 48, 7)
    assert k == {"K1": 672, "K2": 3409, "K2s": 0, "K4": 0, "K6": 0}
    assert c == {"all_to_all": 1344, "all_reduce": 0}


def test_usp_hp_tier_runs_k1(tmp_path):
    """The 13B's tier (b) under USP at sp = 4 (head dim 128, 8 heads): the
    self-attention after the Ulysses exchange and the cross-attention both
    go through K1's wrapper, never K6's; every linear through K2's."""
    for calls in tmesh.spawn_ranks(
            workers.usp_hp_calls, 4, backend="gloo", timeout=120.0,
            store_dir=str(tmp_path)):
        assert calls == {"K1": 2 * LAYERS, "K2": 10 * LAYERS + 7}


@pytest.mark.parametrize("kind", ["ltx", "wan"])
@pytest.mark.parametrize("world", [2, 4])
def test_tp_int8_forward_equals_one_process_bit_for_bit(tmp_path, kind,
                                                        world):
    """In the dynamic-int8 tier a forward cut over tp is one process's bit
    for bit: the row-parallel linears sum the ranks' int32 accumulators
    before K2's epilogue, and the q/k norms sum their squares in float64,
    so nothing rounds in another order (fp32 partial sums differed by one
    rounding, which the int8 quantizers downstream turned into other
    codes, and grew through the layers: 35 dB on a Wan t2v-14B request)."""
    one = tmesh.spawn_ranks(workers.tp_int8_forward, 1, backend="gloo",
                            timeout=120.0, store_dir=str(tmp_path),
                            args=(kind,))[0]
    for out in tmesh.spawn_ranks(workers.tp_int8_forward, world,
                                 backend="gloo", timeout=120.0,
                                 store_dir=str(tmp_path), args=(kind,)):
        assert (out == one).all()


@pytest.fixture(scope="module")
def train_counted(tmp_path_factory):
    return tmesh.spawn_ranks(
        workers.train_counts, 4, backend="gloo", timeout=120.0,
        store_dir=str(tmp_path_factory.mktemp("train")), args=(LAYERS,))


@pytest.mark.parametrize("layout", sorted(chip_smoke.CARDS_TRAIN_MESHES))
def test_train_expect_counts_what_a_step_runs(train_counted, layout):
    """Per-block remat recomputes each block's collectives in the
    backward, which then runs their own backward; the loss and the grads'
    buckets are summed over dp and sp, the global norm's squares over
    tp."""
    for rank, seen in enumerate(train_counted):
        calls, buckets = seen[layout]
        assert buckets > 1, buckets
        assert calls == chip_smoke.train_expect(layout, LAYERS, buckets), (
            rank, calls)


CLIP_LAYERS = 3


def test_cards_i2v_expect_counts_what_a_request_runs(tmp_path):
    """A step's DiT forward of the i2v request over tp = 4 (K4 for the
    self, text and image attentions; K2s on the three row-parallel linears
    a block, K2 on the rest; the block's tp all-reduces), and CLIP's
    blocks (the penultimate block's features: one K4 call a block but the
    last) whole on every rank."""
    k, c = chip_smoke.cards_i2v_expect(LAYERS, 1, CLIP_LAYERS - 1)
    assert k["K4"] == k["K4d128"] + k["K4d80"] == k["K2p"]
    for dit, clip, calls in tmesh.spawn_ranks(
            workers.i2v_counts, 4, backend="gloo", timeout=120.0,
            store_dir=str(tmp_path), args=(LAYERS, CLIP_LAYERS)):
        assert dit == {"K2": k["K2"], "K2s": k["K2s"], "K4": k["K4d128"]}
        assert clip == {"K4": k["K4d80"]}
        assert calls == {"all_reduce": c["all_reduce"]}

"""The task-aligned assignment's plain version (kernels/tal.py), and
ops/tal.py::task_aligned_assign through its wrapper, against the JAX
package's task_aligned_assign on the CPU.

Every output is a discrete function of the decisions (one-hot scores,
copied GT boxes, labels, slots, the foreground mask), so all five are held
bit for bit, at k = 10 and k = 1, on the cases of tests/tal_cases.py; each
built case is also held to show what it was built for (a padded slot
winning a resolve, the anchor-0 fallback, a zero-align member, a tie of
identical boxes). The card's kernels are held to this plain version in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.ops import tal as JT
from leanyolo_tpu_torch.kernels import LAUNCHES, bounds
from leanyolo_tpu_torch.kernels import tal as KT
from leanyolo_tpu_torch.ops import tal as TT
from leanyolo_tpu_torch.ops.topk import topk_membership
from tal_cases import CASES, _base, scores_of, tal_case, tensors

FIELDS = ("target_labels", "target_bboxes", "target_scores", "fg_mask", "target_gt_idx")


def _nc(c: dict) -> int:
    return scores_of(c).shape[-1]


def _jax(c: dict, topk: int) -> dict:
    out = JT.task_aligned_assign(jnp.asarray(scores_of(c)), jnp.asarray(c["pd_bboxes"]), jnp.asarray(c["anc"]),
                                 jnp.asarray(c["gt_labels"]), jnp.asarray(c["gt_bboxes"]), jnp.asarray(c["mask_gt"]),
                                 topk=topk, num_classes=_nc(c))
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def _same(got, ref: dict, what: str) -> None:
    for f, g in zip(FIELDS, got):
        assert g.numpy().dtype == ref[f].dtype, (what, f)
        np.testing.assert_array_equal(g.numpy(), ref[f], err_msg=f"{what} {f}")


def _spot(name: str, c: dict, topk: int, got) -> None:
    """What the built case must show, read from the plain version."""
    labels, boxes, scores, fg, idx = (t.numpy() for t in got)
    spot = c["spot"]
    if name == "masked_wins":
        i, a, s = spot["image"], spot["anchor"], spot["slot"]
        assert fg[i, a] and idx[i, a] == s and not c["mask_gt"][i, s]
    elif name == "fallback":
        k = min(topk, c["anc"].shape[0])
        _, has_any, *_ = KT.candidates_plain(*tensors(c), k)
        i = spot["image"]
        assert not has_any[i, spot["slot"]] and fg[i, spot["anchor"]] and idx[i, spot["anchor"]] == spot["slot"]
        assert not (fg[i] & (idx[i] == spot["empty"])).any()
    elif name == "few_positive":
        i, a, s = spot["image"], spot["anchor"], spot["slot"]
        *_, align = KT.candidates_plain(*tensors(c), topk)
        assert float(align[i, s, a]) == 0.0
        assert bool(fg[i, a] and idx[i, a] == s) == (topk == 10)  # a member at k = 10 only
    elif name == "twins":
        i = spot["image"]
        claimed = fg[i] & np.isin(idx[i], [spot["slot"], spot["twin"]])
        assert claimed.any() and (idx[i][claimed] == spot["slot"]).all()
    elif name == "all_masked":
        assert not fg[1].any() and (idx[1] == 0).all() and not scores[1].any()
        assert (labels[1] == max(c["gt_labels"][1, 0], 0)).all() and (boxes[1] == c["gt_bboxes"][1, 0]).all()
    elif name == "concat":
        assert not tensors(c)[0].is_contiguous()
    elif name in ("nan_logit", "inf_box", "huge_box"):
        i, a, slot = spot["image"], spot["anchor"], spot["slot"]
        winners, has_any, mask_in, overlaps, align = KT.candidates_plain(*tensors(c), topk)
        assert not mask_in[i, :, a].any()  # outside every box
        if name == "huge_box":
            o = overlaps[i, slot, [a, spot["inside"]]]
            assert bool(torch.isfinite(o).all()) and bool(mask_in[i, slot, spot["inside"]])
            assert float(align[i, slot, a]) == 0.0 and not np.signbit(float(align[i, slot, a]))
        else:
            assert bool(torch.isnan(align[i, slot, a])) and not bool(has_any[i, slot])
            assert int(winners[i, slot, 0]) == a  # NaN ranks first
            if name == "nan_logit":  # every valid row of the image, whatever its class
                assert bool(torch.isnan(align[i, torch.from_numpy(c["mask_gt"][i]), a]).all())
    elif name == "chunk_ties":
        i, slot = spot["image"], spot["slot"]
        winners, _, mask_in, _, align = KT.candidates_plain(*tensors(c), topk)
        inside = torch.nonzero(mask_in[i, slot]).flatten()
        assert len(inside) == c["anc"].shape[0] and bool((align[i, slot] == align[i, slot, 0]).all())
        assert winners[i, slot].tolist() == inside[:topk].tolist()
    elif name == "k_ge_a":
        winners, *_ = KT.candidates_plain(*tensors(c), min(topk, c["anc"].shape[0]))
        assert (winners is None) == (topk >= c["anc"].shape[0])


@pytest.mark.parametrize("topk", [10, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_bit_exact_against_jax(name, topk):
    """The plain version and task_aligned_assign (through the wrapper, which
    takes the plain version for CPU tensors, launching nothing) equal JAX's
    five outputs bit for bit."""
    c = tal_case(name)
    ref = _jax(c, topk)
    before = dict(LAUNCHES)
    via_op = TT.task_aligned_assign(*tensors(c), topk=topk, num_classes=_nc(c))
    assert LAUNCHES == before
    _same(via_op, ref, f"{name} task_aligned_assign")
    plain = KT.assign_plain(*tensors(c), topk=topk, num_classes=_nc(c))
    _same(plain, ref, f"{name} assign_plain")
    assert ref["fg_mask"].any() or name == "all_masked"
    _spot(name, c, topk, plain)


@pytest.mark.parametrize("topk", [10, 1, 3])
@pytest.mark.parametrize("name", ["n16", "twins", "few_positive"])
def test_winners_are_the_topk_membership_set(name, topk):
    """Pass 1's winner list (k rounds of first-occurrence argmax, in rank
    order) is the set `topk_membership` admits, JAX's K6 spelled in torch."""
    c = tal_case(name)
    winners, has_any, mask_in, overlaps, align = KT.candidates_plain(*tensors(c), topk)
    member = torch.zeros_like(mask_in).scatter_(2, winners, True)
    assert torch.equal(member, topk_membership(align, topk))
    ranked = torch.gather(align, 2, winners)
    assert bool((ranked[..., :-1] >= ranked[..., 1:]).all())
    assert torch.equal(has_any, align.amax(-1) > 1e-9)


def test_batch_equals_its_halves():
    """An image's assignment does not depend on the rest of the batch (the
    data-parallel shards and a resumed run rest on it)."""
    c = _base(np.random.RandomState(5), 4, 16)
    whole = KT.assign_plain(*tensors(c), topk=10, num_classes=_nc(c))
    halves = [KT.assign_plain(*tensors(c, rows=r), topk=10, num_classes=_nc(c)) for r in (slice(0, 2), slice(2, 4))]
    for w, h0, h1 in zip(whole, *halves):
        assert torch.equal(w, torch.cat([h0, h1]))


def test_check_mode_returns_the_intermediates():
    """check=True adds the CIoU and the alignment [B, N, A], the plain
    version's own, every row (padded ones' align is zero)."""
    c = tal_case("n16")
    args = tensors(c)
    out, (overlaps, align) = KT.assign(*args, topk=10, num_classes=_nc(c), check=True)
    _same(out, _jax(c, 10), "check mode")
    *_, o_ref, a_ref = KT.candidates_plain(*args, 10)
    assert torch.equal(overlaps, o_ref) and torch.equal(align, a_ref)
    assert not align[~torch.from_numpy(c["mask_gt"])].any()


def test_no_gt_slot_gives_background():
    """With no GT slot every anchor is background: label num_classes, no
    foreground, zero scores (JAX's early return)."""
    c = tal_case("n1")
    s, pb, anc, gl, gb, gm = tensors(c)
    out = TT.task_aligned_assign(s, pb, anc, gl[:, :0], gb[:, :0], gm[:, :0], topk=10, num_classes=_nc(c))
    ref = JT.task_aligned_assign(*(jnp.asarray(t.numpy()) for t in (s, pb, anc, gl[:, :0], gb[:, :0], gm[:, :0])),
                                 topk=10, num_classes=_nc(c))
    _same(out, {f: np.asarray(getattr(ref, f)) for f in FIELDS}, "no GT slot")
    assert (out.target_labels == _nc(c)).all() and not out.fg_mask.any() and not out.target_scores.any()


def test_profile_families_of_the_kernels():
    """profile_step's table holds each kernel as a family of its own: the
    names as a trace of the training step on an NVIDIA H100 recorded them."""
    from leanyolo_tpu_torch.utils.profiling import _family

    for name in ("tal_candidates_kernel", "tal_targets_kernel"):
        assert _family(f"(anonymous namespace)::{name}(TalArgs)") == name


def test_tal_work_counts_each_byte_once():
    """bounds.tal_work: the operations a pair (the SASS counts of
    tools/tal_pair_ops: 218 for the full chain, 16 for every pair of a valid
    slot) and the bytes: every input read once (every logit of an image with
    a valid slot, since a NaN at any class makes the anchor's score NaN),
    every output written once."""
    assert (bounds.TAL_PAIR_OPS, bounds.TAL_TEST_OPS) == (218, 16)
    b, n, a, c = 32, 16, 8400, 80
    read = bounds.tal_work(b, n, a, c, 10, valid=203, images=31, inside=4800, part="candidates")
    assert read == (b * a * 16 + a * 8 + b * n * 21 + 31 * a * c * 4, 31 * a * c + 203 * a * 16 + 4800 * 218)
    written = bounds.tal_work(b, n, a, c, 1, part="targets")
    assert written == (b * a * (4 + 4 + 16 + 1 + 4 * c), 0)
    assert bounds.tal_work(b, n, a, c, 10, valid=203, images=31, inside=4800) == (read[0] + written[0], read[1])
    assert bounds.tal_work(2, 3, 5, 4, 1, part="candidates")[1] == 2 * 5 * 4 + 6 * 5 * (16 + 218)  # defaults: all
    ms, by = bounds.bound(*read, bounds.FP32_OPS_PER_S)
    assert by == "bytes" and abs(ms - read[0] / 3.35e12 * 1e3) < 1e-12


def test_tal_pair_ops_counts_operations_of_the_listing():
    """tools/tal_pair_ops counts a probe's SASS instructions up to its first
    EXIT, leaving out loads, stores, moves and control flow (a listing in
    cuobjdump's format)."""
    from leanyolo_tpu_torch.tools.tal_pair_ops import count

    sass = """
        Function : probe_test
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0020*/                   FADD R5, R2, -R3 ;
        /*0030*/              @!P0 FSETP.GT.AND P1, PT, R5, 1e-09, PT ;
        /*0040*/                   MOV R7, 0x1 ;
        /*0050*/                   MUFU.RCP R8, R5 ;
        /*0060*/                   STG.E desc[UR4][R4.64], R8 ;
        /*0070*/                   EXIT ;
        /*0080*/                   FADD R9, R9, R9 ;
        Function : probe_chain
        /*0000*/                   FFMA R1, R2, R3, R4 ;
        /*0010*/                   EXIT ;
    """
    assert count(sass, "probe_test") == {"ops": 3, "by_opcode": {"FADD": 1, "FSETP": 1, "MUFU": 1}}
    assert count(sass, "probe_chain")["ops"] == 1

"""The port's evals (`grove_tpu_torch/evals/`) against the JAX package's.

The port keeps copies of `grove_tpu/evals/*` (it imports nothing of the JAX
package). Each copy is held to its original twice: by source (every module's
text after its docstring, and every function and class by
`inspect.getsource`), and by results (the cases of `tests/test_evals.py`
and the hand-derived goldens of `tests/test_evals_golden.py`, run through
both packages, and the two eval CLIs on one synthetic set and one
predictions pickle, whose metrics must be equal).
"""

import ast
import importlib
import inspect
import math
import pickle
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
MODULES = ("anet", "captions", "iground", "lemma", "meteor", "pointing",
           "ptb", "run_all", "run_iground", "spice", "textsim", "vidstg")
PACKAGES = ("grove_tpu", "grove_tpu_torch")


def _after_docstring(path: Path) -> str:
    text = path.read_text()
    tree = ast.parse(text)
    start = (tree.body[1].lineno if ast.get_docstring(tree)
             else tree.body[0].lineno)
    return "".join(text.splitlines(keepends=True)[start - 1:])


def _definitions():
    """(module, name) of every function and class the JAX modules define,
    and of every method of those classes."""
    out = []
    for mod in MODULES:
        tree = ast.parse((ROOT / "grove_tpu" / "evals" / f"{mod}.py")
                         .read_text())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                out.append((mod, node.name))
            if isinstance(node, ast.ClassDef):
                out += [(mod, f"{node.name}.{m.name}") for m in node.body
                        if isinstance(m, ast.FunctionDef)]
    return out


def test_every_eval_module_is_copied():
    want = sorted(p.name for p in (ROOT / "grove_tpu" / "evals").iterdir()
                  if p.suffix in (".py", ".md"))
    got = sorted(p.name for p in (ROOT / "grove_tpu_torch" / "evals")
                 .iterdir() if p.suffix in (".py", ".md"))
    assert got == want
    assert sorted(f"{m}.py" for m in MODULES) == sorted(
        n for n in want if n.endswith(".py") and n != "__init__.py")
    assert ((ROOT / "grove_tpu_torch" / "evals" / "__init__.py").read_text()
            == (ROOT / "grove_tpu" / "evals" / "__init__.py").read_text())


@pytest.mark.parametrize("module", MODULES)
def test_eval_module_copy_equals_original(module):
    """The module's text after its docstring is the original's (the
    relative imports included: `run_iground`'s `..data.datasets.howto100m`
    reaches the port's copy)."""
    got, want = (_after_docstring(ROOT / pkg / "evals" / f"{module}.py")
                 for pkg in PACKAGES)
    assert got == want


@pytest.mark.parametrize("module,name", _definitions())
def test_eval_definition_copy_equals_original(module, name):
    import functools
    got, want = (inspect.getsource(functools.reduce(
        getattr, name.split("."),
        importlib.import_module(f"{pkg}.evals.{module}")))
        for pkg in PACKAGES)
    assert got == want


@pytest.fixture(params=PACKAGES)
def ev(request):
    """One package's eval modules."""
    return SimpleNamespace(**{m: importlib.import_module(
        f"{request.param}.evals.{m}") for m in MODULES})


# ---------------------------------------------------------------------------
# the cases of tests/test_evals.py, through both packages
# ---------------------------------------------------------------------------

def test_compute_iou_plus_one_convention(ev):
    a = [0, 0, 9, 9]
    assert ev.iground.compute_iou(a, a) == 1.0
    b = [5, 0, 14, 9]
    assert abs(ev.iground.compute_iou(a, b) - (50 / 150)) < 1e-9


def test_mean_iou_perfect(ev):
    gts = {"v": [{"bboxes": [[0, 0, 10, 10]], "labels": ["a"]}]}
    preds = {"v": [{"bboxes": [[0, 0, 10, 10]], "labels": ["a"]}]}
    assert ev.iground.mean_iou(preds, gts) == 1.0
    assert ev.iground.mean_iou(preds, gts, mode="video") == 1.0


def test_grounding_recall_matching(ev):
    gts = {"v": [{"bboxes": [[0, 0, 10, 10], [20, 20, 30, 30]],
                  "labels": ["a red cup", "the dog"]}]}
    preds = {"v": [{"bboxes": [[0, 0, 10, 10], [20, 20, 30, 30]],
                    "labels": ["red cup", "a cat"]}]}
    assert ev.iground.grounding_recall(preds, gts) == 0.5


def test_box_ap_perfect_and_miss(ev):
    gts = {"v": [{"bboxes": [[0, 0, 10, 10]], "labels": ["x"]}]}
    preds = {"v": [{"bboxes": [[0, 0, 10, 10]], "labels": ["x"],
                    "scores": [0.9]}]}
    ap = ev.iground.box_average_precision(preds, gts)
    assert ap["AP50"] > 0.99 and ap["AP"] > 0.99
    preds_bad = {"v": [{"bboxes": [[50, 50, 60, 60]], "labels": ["x"],
                        "scores": [0.9]}]}
    assert ev.iground.box_average_precision(preds_bad, gts)["AP"] == 0.0


def test_bleu_identity(ev):
    scores = ev.captions.bleu({"1": ["a cat sits on the mat"]},
                              {"1": "a cat sits on the mat"})
    for s in scores:
        assert abs(s - 1.0) < 1e-9


def test_bleu_partial(ev):
    scores = ev.captions.bleu({"1": ["the cat is on the mat"]},
                              {"1": "the cat on the mat"})
    assert 0 < scores[3] < 1.0
    assert scores[0] > scores[3]


def test_rouge_l(ev):
    gts = {"1": ["a b c d e"]}
    assert ev.captions.rouge_l(gts, {"1": "a b c d e"}) == 1.0
    assert 0 < ev.captions.rouge_l(gts, {"1": "a c e"}) < 1.0


def test_cider_identity_beats_mismatch(ev):
    gts = {"1": ["a red block moves past the table"],
           "2": ["the green ball bounces"],
           "3": ["someone slices an onion"]}
    res_good = {k: v[0] for k, v in gts.items()}
    res_bad = {k: "completely unrelated words here" for k in gts}
    assert ev.captions.cider_d(gts, res_good) > ev.captions.cider_d(gts,
                                                                   res_bad)


def test_caption_metrics_bundle(ev):
    out = ev.captions.caption_metrics(
        {"1": ["a cat sits quietly on the mat"]},
        {"1": "a cat sits quietly on the mat"})
    assert out["Bleu_4"] > 0.99
    assert out["METEOR"] > 0.95
    assert out["SPICE"] is None


def test_porter_stem_canonical_examples(ev):
    cases = {
        "caresses": "caress", "ponies": "poni", "caress": "caress",
        "cats": "cat", "agreed": "agre", "plastered": "plaster",
        "motoring": "motor", "sing": "sing", "conflated": "conflat",
        "sized": "size", "hopping": "hop", "falling": "fall",
        "failing": "fail", "happy": "happi", "sky": "sky",
        "relational": "relat", "conditional": "condit",
        "vietnamization": "vietnam", "operator": "oper",
        "triplicate": "triplic", "formative": "form",
        "electrical": "electr", "hopefulness": "hope",
        "revival": "reviv", "adjustment": "adjust",
        "adoption": "adopt", "replacement": "replac",
        "probate": "probat", "rate": "rate", "cease": "ceas",
        "controll": "control", "roll": "roll",
    }
    for word, want in cases.items():
        assert ev.meteor.porter_stem(word) == want, word


def test_meteor_hand_computed(ev):
    m = ev.meteor.meteor_sentence
    assert abs(m(["this is a cat"], "this is a cat") - (1 - 0.5 / 64)) < 1e-9
    assert abs(m(["a b"], "b a") - 0.5) < 1e-9
    assert m(["the cat runs"], "the cats running") > 0.9
    assert m(["x y z"], "p q r") == 0.0
    assert abs(m(["a b c d"], "a b") - (10 / 19) * (15 / 16)) < 1e-9
    assert m(["a b", "p q"], "a b") == m(["a b"], "a b")


def test_vidstg_viou(ev):
    gt = {"v1": {"frame_ids": [0, 1], "boxes": [[0, 0, 10, 10],
                                                [0, 0, 10, 10]]}}
    pred = {"v1": {"frame_ids": [0, 1],
                   "boxes": [np.array([[0, 0, 10, 10]]),
                             np.array([[0, 0, 5, 10]])],
                   "qtype": "declarative"}}
    out = ev.vidstg.evaluate_vidstg(pred, gt)
    assert abs(out["declarative_gt_viou"] - 0.75) < 1e-6
    assert out["declarative_gt_viou@0.5"] == 1.0


def test_pointing_accuracy(ev):
    gt = [{"video_id": "v", "segment_idx": 0,
           "segment_bboxes": [(0, 0, 10, 10), (20, 20, 30, 30), None]}]
    preds = {"v_0": {"final_boxes": [np.array([[2, 2, 6, 6]]),
                                     np.array([[0, 0, 5, 5]]), None]}}
    acc, correct, valid = ev.pointing.pointing_accuracy(preds, gt)
    assert valid == 2 and correct == 1
    assert abs(acc - 50.0) < 1e-9


def test_meteor_repeated_word_alignment(ev):
    s = ev.meteor.meteor_sentence(["b a b"], "a b")
    assert abs(s - (20 / 29) * (15 / 16)) < 1e-9


def test_english_lemma_classes(ev):
    lemma = ev.lemma.english_lemma
    for word, want in [("cups", "cup"), ("babies", "baby"),
                       ("dishes", "dish"), ("knives", "knife"),
                       ("children", "child"), ("people", "person"),
                       ("glasses", "glass"), ("tomatoes", "tomato"),
                       ("slicing", "slice"), ("running", "run"),
                       ("stopped", "stop"), ("scissors", "scissors"),
                       ("bus", "bus"), ("cat", "cat")]:
        assert lemma(word) == want, word
    assert ev.anet.naive_lemma("babies") == "baby"


def test_lemma_regular_ve_words_not_mangled(ev):
    lemma = ev.lemma.english_lemma
    for word, want in [("gloves", "glove"), ("waves", "wave"),
                       ("moves", "move"), ("sleeves", "sleeve"),
                       ("knives", "knife"), ("leaves", "leaf")]:
        assert lemma(word) == want


# ---------------------------------------------------------------------------
# the goldens of tests/test_evals_golden.py (derivations there), through
# both packages
# ---------------------------------------------------------------------------

TINY, SMALL = 1e-15, 1e-9   # pycocoevalcap bleu_scorer.py smoothing


def test_bleu_corpus_golden(ev):
    gts = {"A": ["the cat sat on the mat", "a cat sat"],
           "B": ["a dog runs very fast"]}
    res = {"A": "the cat sat", "B": "a dog runs fast"}
    correct, guess = [7, 4, 2, 0], [7, 5, 3, 1]
    prod, expected = 1.0, []
    for k in range(4):
        prod *= (correct[k] + TINY) / (guess[k] + SMALL)
        expected.append(prod ** (1.0 / (k + 1)))
    bp = math.exp(1 - 1 / ((7 + TINY) / (8 + SMALL)))
    for g, e in zip(ev.captions.bleu(gts, res), expected):
        assert abs(g - e * bp) < 1e-9


def test_bleu_closest_ref_tie_prefers_shorter(ev):
    got = ev.captions.bleu({"A": ["b c", "a b c d"]}, {"A": "a b c"})
    assert abs(got[0] - (3 + TINY) / (3 + SMALL)) < 1e-12


def test_rouge_l_golden_single_ref(ev):
    score = ev.captions.rouge_l({"1": ["the cat lay on the mat"]},
                                {"1": "the cat sat on the mat"})
    assert abs(score - 5 / 6) < 1e-9


def test_rouge_l_golden_separate_prec_rec_maxima(ev):
    gts = {"1": ["a b c d e f", "a c"], "2": ["p q"]}
    res = {"1": "a b c", "2": "p q"}
    assert abs(ev.captions.rouge_l(gts, res) - 1.0) < 1e-9


def test_rouge_l_golden_multi_item_mean(ev):
    gts = {"1": ["the cat lay on the mat"], "2": ["x y z w"]}
    res = {"1": "the cat sat on the mat", "2": "x y"}
    expected = (5 / 6 + 1.22 / 1.94) / 2
    assert abs(ev.captions.rouge_l(gts, res) - expected) < 1e-9


def test_cider_d_golden(ev):
    gts = {"1": ["a cat sits"], "2": ["a dog runs"]}
    res = {"1": "a cat sits", "2": "a dog naps"}
    assert abs(ev.captions.cider_d(gts, res) - 5.0) < 1e-9


def test_cider_d_count_clipping_golden(ev):
    gts = {"1": ["cat cat"], "2": ["dog sits"]}
    res = {"1": "cat cat cat", "2": "dog sits"}
    expected = (35 / 12 * math.exp(-1 / 72) + 5.0) / 2
    assert abs(ev.captions.cider_d(gts, res) - expected) < 1e-9


def test_coco_iou_no_plus_one(ev):
    iou = ev.iground.coco_iou
    assert iou([0, 0, 10, 10], [0, 0, 10, 10]) == 1.0
    assert iou([20, 20, 28, 30], [20, 20, 30, 30]) == 0.8
    assert iou([0, 0, 10, 10], [10, 0, 20, 10]) == 0.0


def test_box_ap_golden(ev):
    gts = {"v": [{"bboxes": [[0, 0, 10, 10], [20, 20, 30, 30]],
                  "labels": ["x", "y"]}]}
    preds = {"v": [{"bboxes": [[0, 0, 10, 10], [20, 20, 28, 30],
                               [50, 50, 60, 60]],
                    "labels": ["x", "y", "z"],
                    "scores": [0.9, 0.8, 0.7]}]}
    out = ev.iground.box_average_precision(preds, gts)
    assert abs(out["AP"] - (7 * 1.0 + 3 * (51 / 101)) / 10) < 1e-9
    assert abs(out["AP50"] - 1.0) < 1e-9
    assert abs(out["AP75"] - 1.0) < 1e-9


def test_box_ap_golden_false_positive_ordering(ev):
    gts = {"v": [{"bboxes": [[0, 0, 10, 10]], "labels": ["x"]}]}
    preds = {"v": [{"bboxes": [[40, 40, 50, 50], [0, 0, 10, 10]],
                    "labels": ["x", "x"], "scores": [0.9, 0.8]}]}
    out = ev.iground.box_average_precision(preds, gts)
    for k in ("AP", "AP50", "AP75"):
        assert abs(out[k] - 0.5) < 1e-9


# ---------------------------------------------------------------------------
# the CLIs, both packages on one synthetic set and one predictions pickle
# ---------------------------------------------------------------------------

def _random_boxes(rng, n, w=96, h=64):
    x = rng.uniform(0, w / 2, (n, 1))
    y = rng.uniform(0, h / 2, (n, 1))
    return np.concatenate([x, y, x + rng.uniform(8, w / 2, (n, 1)),
                           y + rng.uniform(8, h / 2, (n, 1))], 1)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cli_metrics(task, tmp_path, pred, args):
    path = tmp_path / f"{task}_pred.pkl"
    with open(path, "wb") as f:
        pickle.dump(pred, f)
    out = []
    for pkg in PACKAGES:
        if task == "iground":
            main = importlib.import_module(f"{pkg}.evals.run_iground").main
            out.append(main(args + ["--pred", str(path)]))
        else:
            main = importlib.import_module(f"{pkg}.evals.run_all").main
            out.append(main([task] + args + ["--pred", str(path)]))
    # the keys chip_smoke.py's phase 10 requires are the JAX evals'
    tasks = {"pointing": "groundingyoutube"}
    assert set(out[0]) == _chip_smoke().INFER_METRICS[tasks.get(task, task)]
    return out


def test_run_iground_cli_equals_original(tmp_path):
    from grove_tpu.data.synthetic import make_synthetic_howto_dataset
    ann_dir, video_dir, keys = make_synthetic_howto_dataset(
        str(tmp_path), num_videos=3, num_frames=6)
    rng = np.random.default_rng(0)
    pred = {}
    for i, key in enumerate(keys):
        frames = 6 - i      # a truncated prediction is aligned by the eval
        boxes = [_random_boxes(rng, int(rng.integers(0, 3)))
                 for _ in range(frames)]
        pred[f"{key}_0"] = {
            "pred_bboxes": boxes,
            "pred_labels": [["red cup"] * len(b) for b in boxes],
            "probs_temp_objectness": [rng.uniform(0.5, 1, len(b))
                                      for b in boxes],
            "pred_text": ["a red cup moves", "someone slices bread",
                          "the dog"][i],
        }
    got, want = _cli_metrics("iground", tmp_path, pred,
                             ["--ann_dir", ann_dir, "--video_dir",
                              video_dir])
    assert got == want
    assert {"AP", "AP50", "mIoU_video", "recall_video", "CIDEr"} <= set(got)


def test_run_all_vidstg_cli_equals_original(tmp_path):
    import json
    from grove_tpu.data.synthetic import make_synthetic_vidstg
    ann_path, _ = make_synthetic_vidstg(str(tmp_path), num_videos=2,
                                        num_frames=8)
    rng = np.random.default_rng(1)
    with open(ann_path) as f:
        videos = json.load(f)["videos"]
    pred = {str(v["video_id"]): {
        "frame_ids": list(range(8)),
        "boxes": [_random_boxes(rng, 1) for _ in range(8)],
        "qtype": v.get("qtype", "declarative")} for v in videos}
    got, want = _cli_metrics("vidstg", tmp_path, pred, ["--ann", ann_path])
    assert got == want and "declarative_gt_viou" in got


def test_run_all_anet_cli_equals_original(tmp_path):
    import json
    from grove_tpu.data.synthetic import make_synthetic_anet
    ann_path, _, _ = make_synthetic_anet(str(tmp_path))
    rng = np.random.default_rng(2)
    with open(ann_path) as f:
        ref = json.load(f)
    pred = {}
    for vid, ann in ref.items():
        for seg, s in ann["segments"].items():
            clss = [c[0] for c in s["process_clss"]]
            pred.setdefault(vid, {})[seg] = {
                "clss": clss, "idx_in_sent": [s["tokens"].index(c)
                                              for c in clss],
                "bbox_for_all_frames": [_random_boxes(rng, 10).tolist()
                                        for _ in clss]}
    got, want = _cli_metrics("anet", tmp_path, pred, ["--ann", ann_path])
    assert got == want
    assert {"localization_accuracy", "f1_all"} <= set(got)


def test_run_all_pointing_cli_equals_original(tmp_path):
    from grove_tpu.data.synthetic import make_synthetic_pointing
    _, _, gt = make_synthetic_pointing(str(tmp_path), num_clips=3)
    gt_path = tmp_path / "gt.pkl"
    with open(gt_path, "wb") as f:
        pickle.dump(gt, f)
    rng = np.random.default_rng(3)
    pred = {f"{g['video_id']}_0": {"final_boxes": [
        _random_boxes(rng, 1) for _ in g["segment_bboxes"]]} for g in gt}
    got, want = _cli_metrics("pointing", tmp_path, pred,
                             ["--ann", str(gt_path)])
    assert got == want and got["valid"] == 6

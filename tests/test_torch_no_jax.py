"""The port runs without JAX and without the JAX package ``ircl_tpu``: it
never imports either, directly or transitively.

The check runs in a subprocess, because this test process has loaded JAX
already (``tests/conftest.py``).
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SERVE_ONE_REQUEST = r"""
import io, json, os, sys, tempfile
import ircl_tpu_torch
from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.serve import RetrievalService, make_service, serve_stdin

wiki = generate(num_docs=60, num_claims=3, seed=3)
store = MemoryDocStore({d: r["text"] for d, r in wiki.docs.items()})
index = tfidf_transform(build_count_index(store, ngram=2, hash_size=1 << 18))
claim = wiki.claims[0].claim
class StagedRanker(TfidfRanker):
    FUSED_LIGHT_MAX_DOCS = 10  # past the fused gate: the staged engine

staged = StagedRanker(index, "cpu", mode="hybrid", df_threshold=4, width_buckets=2,
                      select_rescore=16)
for svc in (
    RetrievalService(TfidfRanker(index, "cpu", mode="hybrid", df_threshold=4,
                                 width_buckets=2), batch_size=4),
    RetrievalService(StagedRanker(index, "cpu", mode="hybrid", df_threshold=4,
                                  width_buckets=2), batch_size=4),
    RetrievalService(staged, batch_size=4),
    RetrievalService(TfidfRanker(index, "cpu", mode="ragged"), batch_size=4),
    None,
):
    if svc is None:
        with tempfile.TemporaryDirectory() as d:
            index.save(os.path.join(d, "i.npz"))
            svc = make_service(os.path.join(d, "i.npz"), device="cpu")
    out = io.StringIO()
    served = serve_stdin(svc, io.StringIO(json.dumps({"query": claim}) + "\n"), out)
    reply = json.loads(out.getvalue())
    assert served == 1 and reply["results"][0], reply
from ircl_tpu_torch.index.chunked import ChunkedHybridRanker
from ircl_tpu_torch.ops import fused_dot_light_cuda, fused_hybrid_cuda, ragged
from ircl_tpu_torch.tools.scale_index import synth_index
chunked = ChunkedHybridRanker(index, "cpu", chunk_docs=25, df_threshold=4, width_buckets=2)
assert chunked.closest_docs_batch([claim], k=3)[0][0] == [
    h["doc_id"] for h in reply["results"][0][:3]]
print("JAX_MODULES", sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu")))
"""


_SERVE_ONE_SENTENCE_REQUEST = r"""
import io, json, sys
import torch
from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.contrastive.state import TrainConfig
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.contrastive.state import init_train_state
from ircl_tpu_torch.models.encoder import EncoderConfig
from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer
from ircl_tpu_torch.ops.dense_topk_cuda import cosine_topk_fused, pad_corpus_t
from ircl_tpu_torch.pipeline.dense_scorer import (
    ContrastiveSentenceScorer, PrecomputedSentenceScorer)
from ircl_tpu_torch.serve import RetrievalService, serve_stdin

wiki = generate(num_docs=40, num_claims=3, seed=3)
store = MemoryDocStore({d: r["text"] for d, r in wiki.docs.items()})
index = tfidf_transform(build_count_index(store, ngram=2, hash_size=1 << 18))
feat = HashEmbedFeaturizer(FeaturizerConfig(dim=16, max_len=16, vocab_buckets=1 << 10),
                           device="cpu")
cfg = TrainConfig(encoder=EncoderConfig(input_size=16, hidden_size=8, output_size=8,
                                        num_layers=1))
state = init_train_state(0, cfg, device="cpu")
scorer = PrecomputedSentenceScorer.from_scorer(
    ContrastiveSentenceScorer(cfg, feat, state, batch_size=8), wiki.sentences)
svc = RetrievalService(TfidfRanker(index, "cpu"), batch_size=4,
                       doc_sentences=wiki.sentences, sentence_scorer=scorer)
out = io.StringIO()
line = json.dumps({"query": wiki.claims[0].claim, "k_sents": 3})
served = serve_stdin(svc, io.StringIO(line + "\n"), out)
reply = json.loads(out.getvalue())
assert served == 1 and len(reply["results"][0]) == 3, reply
assert {"doc_id", "sent_id", "sentence", "score"} == set(reply["results"][0][0])
ct, m = pad_corpus_t(torch.from_numpy(scorer.table), 64)
q = torch.from_numpy(scorer._embed([wiki.claims[0].claim]))
s, i = cosine_topk_fused(q, ct, k=3, chunk=16, m_tile=64, m_real=m, epilogue="fold")
assert i.shape == (1, 3)
print("JAX_MODULES", sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu")))
"""


_SERVE_ONE_CLAIM_REQUEST = r"""
import io, json, sys
import torch
from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.serve import RetrievalService, serve_stdin
from ircl_tpu_torch.verdict.infer import VerdictClassifier
from ircl_tpu_torch.verdict.model import VerdictConfig, init_verdict_params

wiki = generate(num_docs=40, num_claims=3, seed=3)
store = MemoryDocStore({d: r["text"] for d, r in wiki.docs.items()})
index = tfidf_transform(build_count_index(store, ngram=2, hash_size=1 << 18))
tok = WordPieceTokenizer.train([r["text"] for r in wiki.docs.values()], vocab_size=128)
cfg = VerdictConfig(encoder=TransformerConfig(
    vocab_size=tok.vocab_size, hidden=16, layers=1, heads=2, intermediate=32,
    max_positions=128, type_vocab=1, position_offset=2, attention="flash"),
    max_length=128)
params = init_verdict_params(torch.Generator().manual_seed(0), cfg, device="cpu")
svc = RetrievalService(TfidfRanker(index, "cpu"), batch_size=4,
                       verdict_classifier=VerdictClassifier(cfg, params, tok, batch_size=4))
out = io.StringIO()
line = json.dumps({"claim": wiki.claims[0].claim})
served = serve_stdin(svc, io.StringIO(line + "\n"), out)
reply = json.loads(out.getvalue())
assert served == 1 and reply["results"][0]["label"] in ("SUPPORTS", "REFUTES"), reply
assert reply["results"][0]["evidence"], reply
print("JAX_MODULES", sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu")))
"""


# The trainer's MetricsLogger mirrors to TensorBoard through
# torch.utils.tensorboard, which imports TensorFlow where it is installed,
# and TensorFlow Lite imports JAX where that is installed. Neither comes from
# the port, and the GPU machine has neither: the script hides TensorFlow, so
# the writer takes tensorboard's own stub and the check sees the port's
# imports only.
_TRAIN_RESUME_AND_SCORE = r"""
import sys, tempfile
sys.modules["tensorflow"] = None
from ircl_tpu_torch.contrastive.state import TrainConfig
from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.data import DocPairSampler
from ircl_tpu_torch.models.encoder import EncoderConfig
from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer
from ircl_tpu_torch.pipeline.dense_scorer import ContrastiveSentenceScorer
from ircl_tpu_torch.pipeline.intrinsic import mean_claim_evidence_cosine

wiki = generate(num_docs=40, num_claims=8, seed=3)
feat = HashEmbedFeaturizer(FeaturizerConfig(dim=16, max_len=8, vocab_buckets=1 << 10),
                           device="cpu")
cfg = TrainConfig(encoder=EncoderConfig(input_size=16, hidden_size=8, output_size=8,
                                        num_layers=1),
                  loss="ProtoNCE", queue_size=16, queue_start_steps=2, micro_batch=8,
                  cluster_start_steps=1, cluster_update_steps=2, num_clusters=(3,),
                  num_neg_proto=2)
docs = list(wiki.sentences.values())
with tempfile.TemporaryDirectory() as d:
    kw = dict(ckptdir=d + "/c", logdir=d + "/l", device="cpu")
    tr = ContrastiveTrainer(cfg, feat, DocPairSampler(docs, sample="augment"), **kw)
    tr.train(total_steps=3, log_step=3)
    again = ContrastiveTrainer(cfg, feat, DocPairSampler(docs, sample="augment", seed=1),
                               **kw)
    assert again.maybe_resume() == 3 and again.train(total_steps=4, log_step=4).step == 4
    assert tr.refresh_count == 1 and again.refresh_count == 1  # on resume, at step 3
    scorer = ContrastiveSentenceScorer(cfg, feat, again.state, batch_size=8)
    res = mean_claim_evidence_cosine(scorer.embed, wiki.claims, wiki.sentences)
    assert res["pairs"] > 0, res
print("JAX_MODULES", sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu")))
"""


def _run_fresh(script):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    proc = subprocess.run(
        [sys.executable, "-c", script],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


def test_port_serves_a_request_without_loading_jax():
    """A doc request through the fused, the staged (past the gate, and with
    ``select_rescore``), the ragged and the default service; the chunked
    ranker and the new kernels' modules imported beside them."""
    _run_fresh(_SERVE_ONE_REQUEST)


def test_port_serves_a_sentence_request_without_loading_jax():
    """The hash-featurizer encoder, its sentence table, a sentence request
    through ``serve_stdin`` and the dense top-k over the table."""
    _run_fresh(_SERVE_ONE_SENTENCE_REQUEST)


def test_port_serves_a_claim_request_without_loading_jax():
    """The verdict stage with ``attention="flash"`` on a claim line through
    ``serve_stdin``."""
    _run_fresh(_SERVE_ONE_CLAIM_REQUEST)


def test_port_trains_resumes_and_scores_without_loading_jax():
    """A tiny ProtoNCE ``ContrastiveTrainer`` run on the CPU, its checkpoint
    resumed by a fresh trainer, and its state behind the sentence scorer."""
    _run_fresh(_TRAIN_RESUME_AND_SCORE)


def _port_files():
    for base in ("ircl_tpu_torch",):
        for dirpath, _, files in os.walk(os.path.join(ROOT, base)):
            if "_build" in dirpath or "__pycache__" in dirpath:
                continue
            for f in files:
                if f.endswith((".py", ".cu", ".cuh")):
                    yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize(
    "banned",
    ["import jax", "from jax", "torch.compile", "scaled_dot_product_attention"],
)
def test_no_port_file_uses_jax_or_stand_in_kernels(banned):
    files = list(_port_files())
    if banned == "scaled_dot_product_attention":
        # chip_smoke.py times that call beside the flash kernels as a
        # yardstick; the package itself never calls it
        files = [p for p in files if os.path.basename(p) != "chip_smoke.py"]
    assert len(files) >= 15
    offenders = [p for p in files if banned in open(p, encoding="utf-8").read()]
    assert not offenders, offenders


def test_port_imports_nothing_of_the_jax_package():
    """No file of the port, nor ``chip_smoke.py``, imports a module of
    ``ircl_tpu``, JAX-free or not: the port keeps its own copies."""
    offenders = []
    for path in _port_files():
        for line in open(path, encoding="utf-8"):
            s = line.strip()
            if s.startswith(("import ircl_tpu", "from ircl_tpu")) and not (
                s.startswith(("from ircl_tpu_torch", "import ircl_tpu_torch"))
            ):
                offenders.append(f"{path}: {s}")
    assert not offenders, offenders


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """No CUDA device: the smoke exits non-zero and prints no result, both
    in the checkout and as a lone script."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; chip_smoke.py runs for real there")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(lone)):
        proc = subprocess.run(
            [sys.executable, script], cwd=os.path.dirname(script),
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout

"""The port runs without JAX and without the JAX package ``ircl_tpu``: it
never imports either, directly or transitively.

The check runs in a subprocess, because this test process has loaded JAX
already (``tests/conftest.py``).
"""

import json
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


_FRONTS_AND_CLI = r"""
import http.client, json, os, runpy, sys, tempfile, threading
from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.serve import RetrievalService, serve_http
from ircl_tpu_torch.serve_native import serve_native_http

wiki = generate(num_docs=40, num_claims=3, seed=3)
store = MemoryDocStore({d: r["text"] for d, r in wiki.docs.items()})
index = tfidf_transform(build_count_index(store, ngram=2, hash_size=1 << 18))
body = json.dumps({"query": wiki.claims[0].claim}).encode()

def ask(port):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("POST", "/search", body=body)
    r = c.getresponse()
    reply = (r.status, json.loads(r.read()))
    c.close()
    return reply

svc = RetrievalService(TfidfRanker(index, "cpu"), batch_size=4)
server = serve_http(svc, port=0, batch_wait_ms=2.0)
th = threading.Thread(target=server.serve_forever, daemon=True)
th.start()
native = serve_native_http(svc, port=0, batch_wait_ms=2.0)
try:
    a, b = ask(server.server_address[1]), ask(native.port)
    assert a == b and a[0] == 200 and a[1]["results"][0], (a, b)
finally:
    native.close()
    server.shutdown()
    server.server_close()
    server.batcher.close()
    th.join(timeout=60)

def cli(*argv):
    sys.argv = ["ircl_tpu_torch.cli", *argv]
    try:
        runpy.run_module("ircl_tpu_torch.cli", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        assert e.code in (0, None), e.code

cli("--help")
with tempfile.TemporaryDirectory() as d:
    wiki_json = os.path.join(d, "wiki.json")
    with open(wiki_json, "w") as f:
        json.dump(wiki.docs, f)
    cfg = os.path.join(d, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"data": {"data_dir": d, "wiki_json": wiki_json},
                   "index": {"hash_size": 1 << 16}}, f)
    cli("--device", "cpu", "--config", cfg, "build-index")
    assert os.path.exists(os.path.join(d, "index", "tfidf-ngram=2-hash=65536.npz"))
print("JAX_MODULES", sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu")))
"""


# Two gloo ranks on the CPU, spawned by the port's launcher from a fresh
# process; each rank reports the JAX modules it loaded.
_SHARDED_RANKS = r"""
import sys
sys.path.insert(0, "tests")
from _torch_ranks import loaded_jax_modules
from ircl_tpu_torch.parallel.launch import launch

every = launch(loaded_jax_modules, 2, device="cpu")
assert len(every) == 2, every
print("JAX_MODULES", sorted(set(sum(every, [])) | {
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu")}))
"""


# The four experiment tools and the judged bench imported in a fresh process;
# each entry point defaults to the card, so without one it raises before any
# work.
_TOOLS = r"""
import sys
import torch
from ircl_tpu_torch.tools import (bench, eval_e2e, rehearsal_scale, similarity_ab,
                                  verdict_table2)

for tool in (eval_e2e, similarity_ab, verdict_table2, rehearsal_scale, bench):
    if not torch.cuda.is_available():
        try:
            tool.main(["--out", "/nonexistent/never-written.md"]
                      if tool not in (rehearsal_scale, bench) else [])
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError(f"{tool.__name__} ran without a device")
print("JAX_MODULES", sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu")))
"""

# A HuggingFace checkpoint directory (written by the test) loaded as a
# featurizer, with the packages the GPU machine lacks hidden, and two
# sentences through it.
_HF_FEATURIZER = r"""
import sys
for name in ("tensorflow",) + {hidden}:
    sys.modules[name] = None
from ircl_tpu_torch.models.featurizer import FeaturizerConfig, make_featurizer

feat = make_featurizer(FeaturizerConfig(kind="hf", hf_name={path!r}, max_len=12),
                       device="cpu")
ids, mask = feat.encode_host(["A claim, about Σ things.", "second one"])
assert feat.config.dim == 32 and ids.shape == (2, 12) and mask[0].sum() > 3
out = feat.features(ids, mask)
assert out.shape == (2, 12, 32) and bool(out.isfinite().all())
print("JAX_MODULES", sorted(  # the hidden names stand as None
    m for m, mod in sys.modules.items()
    if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu") + {hidden} and mod is not None))
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


def test_port_fronts_and_cli_run_without_loading_jax():
    """``serve_http`` and ``serve_native_http`` on port 0 answer the same
    request, then ``python -m ircl_tpu_torch.cli --help`` and
    ``--device cpu build-index`` on a tiny workspace, in one fresh
    process."""
    _run_fresh(_FRONTS_AND_CLI)


def test_port_runs_sharded_ranks_without_loading_jax():
    """``sharded_cosine_topk``, a TP forward of a tiny transformer, its
    2-stage pipeline forward and a context-parallel forward of a tiny
    verdict model (the ring) on a fresh 2-rank gloo group: neither the
    launching process nor either rank loads JAX or the JAX package."""
    _run_fresh(_SHARDED_RANKS)


def test_port_loads_a_hf_checkpoint_without_transformers(tmp_path):
    """``make_featurizer(kind="hf")`` on a tiny BERT checkpoint directory in
    a fresh process where ``transformers``, ``tokenizers``,
    ``safetensors``, ``huggingface_hub`` and ``regex`` cannot be imported;
    the directory is written here with ``transformers``."""
    transformers = pytest.importorskip("transformers")
    import torch

    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "claim", ",", "about",
             "σ", "things", ".", "second", "one", "##s"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    torch.manual_seed(0)
    transformers.BertModel(transformers.BertConfig(
        vocab_size=len(words), hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=16)).save_pretrained(tmp_path)
    _run_fresh(_HF_FEATURIZER.format(hidden=HF_PACKAGES, path=str(tmp_path)))


def test_port_tools_import_without_jax():
    """``tools/{eval_e2e,similarity_ab,verdict_table2,rehearsal_scale,
    bench}.py`` load neither JAX nor the JAX package, and default to the
    card."""
    _run_fresh(_TOOLS)


# The sitecustomize of a fresh process and of every rank it spawns (they
# inherit PYTHONPATH): an import of JAX or of the JAX package fails there.
# A sitecustomize it shadows still runs.
_REFUSE_JAX_SITE = r"""
import importlib.abc, importlib.machinery, importlib.util, os, sys

class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ircl_tpu"):
            raise ImportError(f"{name}: the port's process imported it")
        return None

sys.meta_path.insert(0, _Refuse())
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


def _run_module_refusing_jax(tmp_path, module, *argv):
    """``python -m module argv`` in a fresh process whose imports of JAX or
    ``ircl_tpu`` fail, in it and in every rank it spawns; its JSON line."""
    (tmp_path / "sitecustomize.py").write_text(_REFUSE_JAX_SITE)
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(tmp_path), ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", module, *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_dry_run_runs_without_loading_jax(tmp_path):
    """``python -m ircl_tpu_torch.graft_entry dryrun 2 --device cpu``: the
    launching process and both ranks run every section without JAX."""
    line = _run_module_refusing_jax(tmp_path, "ircl_tpu_torch.graft_entry", "dryrun", "2",
                                    "--device", "cpu")
    assert line["dryrun"] == 2 and line["backend"] == "gloo"
    assert list(line["sections"]) == ["dp", "dense", "ell", "hybrid", "tp", "sp", "pp",
                                      "pp_moe", "ep", "checkpoint", "cp"]


def test_port_sharded_scale_runs_without_loading_jax(tmp_path):
    """``python -m ircl_tpu_torch.tools.sharded_scale --docs 500 --device
    cpu``: the launching process and its 8 ranks, without JAX."""
    line = _run_module_refusing_jax(tmp_path, "ircl_tpu_torch.tools.sharded_scale",
                                    "--docs", "500", "--device", "cpu")
    assert (line["docs"], line["parity"], line["ranks"]) == (500, "64/64", 8)

def _port_files():
    for base in ("ircl_tpu_torch",):
        for dirpath, _, files in os.walk(os.path.join(ROOT, base)):
            if "_build" in dirpath or "__pycache__" in dirpath:
                continue
            for f in files:
                if f.endswith((".py", ".cu", ".cuh")):
                    yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


HF_PACKAGES = ("transformers", "tokenizers", "safetensors", "huggingface_hub", "regex")


@pytest.mark.parametrize(
    "banned",
    ["import jax", "from jax", "torch.compile", "scaled_dot_product_attention"]
    + [f"{verb} {pkg}" for pkg in HF_PACKAGES for verb in ("import", "from")],
)
def test_no_port_file_uses_jax_or_stand_in_kernels(banned):
    files = list(_port_files())
    if banned == "scaled_dot_product_attention":
        # chip_smoke.py times that call beside the flash kernels as a
        # yardstick; the package itself never calls it
        files = [p for p in files if os.path.basename(p) != "chip_smoke.py"]
    assert len(files) >= 15
    for new in ("serve_native.py", "cli.py", "config.py", "recall.py",
                "profiling.py", "fetch.py", "prepare.py", "mesh.py", "launch.py",
                "common.py", "sharded_index.py", "sharded_hybrid.py", "dp.py",
                "tp.py", "ep.py", "pp.py", "cp.py", "ring_attention.py", "eval_e2e.py",
                "similarity_ab.py", "verdict_table2.py", "rehearsal_scale.py",
                "results.py", "graft_entry.py", "sharded_scale.py", "hf_checkpoint.py",
                "hf_tokenizer.py", "hf_unicode.py"):
        assert any(p.endswith(os.sep + new) for p in files), new
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

"""Two-stage retrieval: sparse doc candidates, then dense sentence re-rank.

Counterpart of ``ircl_tpu/pipeline/``; the recall@k harness is not ported
yet (ROADMAP.md queue 1 item 7).
"""

"""Model (``serving/lm.py`` → ``models/``): the prefills' model operations
(``flops.forward`` at the prompt length, logits at the last position)
over the sum of their step-0 spans (``t_submit`` to ``t_emit``), as a
share of the card's bf16 peak.  Each span holds at least its own work,
so the share cannot pass 100 %."""

from port_bench import flops


def read(run):
    spans = run.record.get("prefill_s")
    if not spans:
        return None
    ops = flops.forward(run.cell.port, run.record["prompt_len"], 1)
    return 100.0 * ops * len(spans) / sum(spans) \
        / flops.peaks()["bf16_flops_per_s"]

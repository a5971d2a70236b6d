"""text_live_token_share (%): the share of the text tower's token
positions that are not padding, over the traced epoch: the program's
counter ``tdwss.text.live_tokens`` (each non-empty row's positions up to
and including its EOT, counted at the collate) over
``tdwss.text.rows`` (the token rows the tower computes) times the
context length, from ``tdwss_torch.utils.profiling``, which counts only
while the profiler records.  Nothing on the CPU, or from a program
without the counters."""


def read(ctx):
    from tdwss_torch.utils import profiling

    if not ctx.on_card or not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    rows = c.get("tdwss.text.rows", 0)
    if not rows or "tdwss.text.live_tokens" not in c:
        return None
    return 100.0 * c["tdwss.text.live_tokens"] / (
        rows * ctx.cfg.text_data.max_seq_len)

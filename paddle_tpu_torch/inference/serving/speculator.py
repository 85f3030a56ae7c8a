"""N-gram / prompt-lookup speculator (counterpart:
``paddle_tpu/inference/serving/speculator.py``; pure Python).

Drafts k candidate tokens per request WITHOUT a second model (the
prompt-lookup decoding family): find the most recent earlier occurrence
of the sequence's trailing n-gram and propose the tokens that followed
it. Served traffic is exactly the shape this exploits — prompts quote
context the answer restates, generations loop through boilerplate — and
the draft is free (a host-side list scan per request per step, no
accelerator work).

Losslessness does NOT depend on draft quality: the verify program
commits only the tokens the target model itself (re)samples
(``sampling.py``), so a bad draft costs rolled-back KV rows, never a
wrong token. That is why ``propose`` may freely pad short continuations
and guess on cold sequences.
"""
from __future__ import annotations


class NGramSpeculator:
    """Prompt-lookup drafter over a token list.

    ``max_ngram``..``min_ngram`` trailing n-grams are tried longest
    first (a longer match is stronger evidence the continuation
    repeats); the MOST RECENT earlier occurrence wins (recency tracks
    the local loop/quote the sequence is currently in).
    """

    def __init__(self, k=4, max_ngram=3, min_ngram=1):
        if k < 1:
            raise ValueError("speculator k must be >= 1")
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need max_ngram >= min_ngram >= 1")
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.proposals = 0
        self.hits = 0          # proposals backed by an n-gram match

    def propose(self, tokens, k=None):
        """Up to ``k`` draft tokens continuing ``tokens`` (prompt +
        generated so far). Returns a possibly-short list — the engine
        pads to its fixed draft shape; an empty/padded draft is safe
        (module docstring)."""
        k = self.k if k is None else int(k)
        self.proposals += 1
        n_tok = len(tokens)
        for n in range(min(self.max_ngram, n_tok - 1),
                       self.min_ngram - 1, -1):
            pattern = list(tokens[n_tok - n:])
            t0 = pattern[0]
            # scan backwards for the most recent earlier occurrence;
            # start excludes the trailing n-gram matching itself. The
            # first-element pre-check keeps the hot loop allocation-free
            # (this scan runs per sequence per verify step — it must
            # stay far under the dispatch it is drafting for)
            for start in range(n_tok - n - 1, -1, -1):
                if tokens[start] == t0 \
                        and tokens[start:start + n] == pattern:
                    # PERIODIC extension: the most recent match sits
                    # close to the end, so its literal continuation is
                    # short (often one token); an index past the end
                    # reads from the draft itself, which unrolls the
                    # loop the match found (period = distance between
                    # the two occurrences) out to the full k — this is
                    # what makes generation loops accept k-for-k
                    cont = []
                    for j in range(k):
                        idx = start + n + j
                        cont.append(int(tokens[idx]) if idx < n_tok
                                    else cont[idx - n_tok])
                    if cont:
                        self.hits += 1
                        return cont
        return []

"""Mean ms of a stereo pair's right-view extraction, host clock, card
synchronized: the benchmark's ``frontend.features`` spans less the
``frontend.extract`` and ``frontend.match_stereo`` spans inside them, over
the features calls. None where no stereo match ran."""


def read(ctx):
    feats, stereo = ctx.spans.get("frontend.features"), ctx.spans.get("frontend.match_stereo")
    if not feats or not stereo:
        return None
    rest = sum(feats) - sum(ctx.spans.get("frontend.extract", ())) - sum(stereo)
    return 1e3 * rest / len(feats)

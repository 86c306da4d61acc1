"""One module a kind of traffic mix; ``mixes/<mix>.json`` names its
driver, whose ``run(ctx)`` returns a ``harness.Run``."""

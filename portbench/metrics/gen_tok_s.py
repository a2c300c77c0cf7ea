"""Tokens generated inside the window over the window's seconds."""


def read(run):
    return run.tl.gen_tok_s()

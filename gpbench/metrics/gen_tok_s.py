"""Tokens generated in the window over the window's seconds."""
KIND, UNIT = "end_to_end", "tokens/s"


def read(run):
    return run.window_numbers()["gen_tok_s"]

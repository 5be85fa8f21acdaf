"""Plain float32 references of the benchmark's model families, one module
each, named by a configuration file's ``reference`` key.  Each takes the
weights the benchmark made (the tree it hands the program, in the dtype it
is served in) and the benchmark's own inputs, works out everything else
again (the float32 weights, the encoder output, the attention over the whole
sequence in place of a cache), and imports nothing of the program.

``logits(params, cfg, prompts, frames, served, mode)`` gives, for each
request, the logits at the positions that predict its served tokens, from a
forward pass over the prompt and the served tokens before each: (B, gen, V)
float32.  ``mode`` "f32" is the reference, "fp8" the control
(`common.linear`).
"""

"""Kinds of step, one module each, named by a traffic file's "loop": each
gives prepare(ctx) (set-up: warm-up and the keeper) and window(ctx,
seconds) -> {"done", "attempted", "window_s", ...}."""

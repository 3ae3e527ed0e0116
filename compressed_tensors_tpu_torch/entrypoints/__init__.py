"""Entry points that work on checkpoints without building a model:
``entrypoints.convert`` rewrites checkpoints of other tools into formats
the engine reads."""

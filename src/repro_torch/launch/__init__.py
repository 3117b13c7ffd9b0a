"""Entry points of the port's language-model trainer (``launch/train.py``)."""

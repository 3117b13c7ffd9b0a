"""Entry points of the port's language-model trainer (``launch/train.py``)
and its dry run and roofline (``launch/{mesh,specs,analytic,roofline,dryrun}.py``)."""

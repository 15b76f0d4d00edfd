"""The flash-attention backward kernel (``csrc/flash_attention_bwd.cu``).

Its source lives apart from the forward's so that the two build and hash
separately; its wrapper (``flash_attention_bwd``) and its plain version
(``flash_attention_bwd_ref``) sit beside the forward's, in
``kernels/flash_attention/ops.py`` and ``ref.py``.
"""

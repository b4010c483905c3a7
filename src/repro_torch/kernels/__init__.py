"""FULL-W2V kernel package of the torch port.

``ref.py`` (plain torch versions) + ``csrc/`` (CUDA sources for sm_90a) +
``_build.py`` (nvcc build, ctypes binding) + ``fullw2v.py`` (kernel
wrappers with launch counters) + ``registry.py`` (backend descriptors,
``StepInputs``, resolution) + ``tables.py`` (``TableSpec``) + ``ops.py``
(backend registrations and ``step``).
"""

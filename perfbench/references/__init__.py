"""Plain references, one module each, named by a configuration's
``reference``.  A reference imports nothing of the program under test.

``transform(re, im, rank, inverse, mode)`` returns the (re, im) planes of
the transform over the last ``rank`` axes: ``mode="f64"`` is the reference
the check compares with, ``mode="bf16x3"`` is the control, the same
arithmetic one precision step below what the configurations state.
"""

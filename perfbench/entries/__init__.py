"""Entry points of the program under test, one module each, named by a
configuration's ``entry``.

``build(config, traffic, devices)`` returns a target with:

    devices                    the chips the cell uses
    shape                      the shape of one array of a call (batch first)
    rank                       how many trailing axes one transform covers
    make_input(key)            the window's first input, on the devices, from
                               a PRNG key, in one jitted call
    call(inverse, arrays)      one call of the timed path; returns its arrays
    planes(arrays)             (re, im) device planes of a call's arrays
    from_planes(re, im)        the inverse of ``planes``
"""

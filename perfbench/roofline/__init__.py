"""A kernel's roofline arithmetic, one module per kernel, found by the
kernel's name: ``match(device op name)`` picks its device operations in a
trace, ``calls(config, kind, branches, b, s)`` lists the calls one forward
of ``kind`` makes, each a dict of shapes, and ``cost(call)`` gives the
(FLOPs, bytes) that call needs: each input byte read once, each output
byte written once."""

"""The program's entry points as the cells drive them, one module a kind of
call, named by a traffic mix's ``entry``. Each module has ``Entry(config,
traffic, seed, device, wrap=None)``, whose construction is the set-up
(inputs and weights on the device), and:

- ``warm()``: the calls that build and warm every shape the window uses;
- ``call(i)``: the window's i-th call, not waited for; ``work_per_call``
  counts what one call completes;
- ``keep(i, out)``: copies of what the check needs of a sampled call;
- ``finish(kept)``: the program's own work on the kept outputs after the
  window (a decode), before its state is freed by ``release()``;
- ``check(kept)``: {number: value} from the plain reference;
- ``needed(calls)``: the work ``calls`` calls need, by ``roofline``'s counts.

``wrap`` takes the program's callable and returns the one to run, so that
the tests and the calibration can put a fault or the control in its place.
"""

"""Drivers: what one iteration of a traffic mix is, and what its check
compares.  A traffic file names its driver (``"driver": "<name>"``,
``drivers/<name>.py``); the driver's ``Driver`` class takes the run's
context, the configuration and the traffic and provides

* ``setup()``: build the program's objects and inputs from the seed and
  run every shape the window will run (the warm-up);
* ``begin_window()``, ``iteration()``: one iteration enqueued on the
  device, the program's own entry point;
* ``work()``: what an iteration counts for the end-to-end readers;
* ``release()``: drop the program's state but what the check needs;
* ``check()``: ``(checks, failed)``, each check ``name -> (value,
  limit)`` (a reading passes when it is at most its limit) and the number
  of checked answers that failed.
"""

"""Cell factories of the port (``step.build_cell``), checkpoints
(``checkpoint``) and the watchdog's timeout (``fault.StepTimeout``)."""

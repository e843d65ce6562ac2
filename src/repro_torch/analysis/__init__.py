"""The port's analysis layer: roofline terms priced on one H100
(``roofline``), FLOP, byte and footprint counts of a step traced on
``meta`` tensors (``opcount``, the counterpart of the reference's HLO
analysis) and a step's breakdown, counted or profiled on the card
(``breakdown``).  Nothing here runs at import."""

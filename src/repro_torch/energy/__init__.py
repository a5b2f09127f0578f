"""Energy accounting: the hardware constants (``hw``), the meter that turns
active and idle seconds into joules and grams (``meter``) and its
conservation-auditing wrapper (``sanitize``), the roofline estimator
(``estimator``) and the green report over the paper's quality
characteristics (``report``)."""

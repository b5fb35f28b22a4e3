"""Training side of the port: the mono train step, optimizer and trainer
(``steps``, ``state``, ``trainer``) and the GRU v9/v10 sequence step and
trainer (``steps_gru``, ``trainer_gru``)."""

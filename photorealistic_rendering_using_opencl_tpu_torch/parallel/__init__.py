"""Several devices over ``torch.distributed``: joining a process group and
the ``rays`` mesh (``distributed``), the sharded render and the all-reduced
train step (``render``), and a one-step check over n ranks (``dryrun``)."""

"""The recsys architectures of the port: DLRM, DCN-v2, Wide&Deep, DIEN
over one stacked embedding table (the reference's
``repro.models.recsys``)."""

"""Hardware model of the card the port serves on (:mod:`repro_torch.roofline.hw`)."""

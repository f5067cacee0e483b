"""`python -m kubeflow_tpu_torch.control.jaxjob`: the controller manager.

It runs against a live apiserver through the REST client and the
shared controller main, which come in a later slice."""

if __name__ == "__main__":
    raise NotImplementedError(
        "the JAXJob controller's main needs the REST client and "
        "control/mains.py, which are not ported yet (ROADMAP Queue 1, item "
        "20b); drive build_controller on a FakeCluster meanwhile")

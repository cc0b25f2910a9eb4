from repro_torch.data.synthetic import (ClassificationData,
                                        teacher_classification)

__all__ = ["ClassificationData", "teacher_classification"]

"""Models of the PyTorch package."""

from .crnn_ctc import CRNNCTC
from .bert import (BertConfig, BertForPretraining, BertModel,
                   MLMHeadOutput, bert_base_config, bert_large_config,
                   pretraining_loss)
from .ernie import (ErnieConfig, ErnieForPretraining, ErnieModel,
                    knowledge_mask)
from .gan import Discriminator, GANTrainStep, Generator
from .gpt_lm import (GPTBlock, GPTConfig, GPTLanguageModel,
                     dense_causal_attention)
from .lenet import LeNet
from .lstm_lm import LMConfig, LSTMLanguageModel
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .nlp import SentimentBiLSTM, SRLBiLSTMCRF
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d)
from .ssd import SSDLite
from .recommender import DeepFM, RecommenderSystem
from .transformer_seq2seq import Seq2SeqConfig, TransformerSeq2Seq
from .transformer_xl import (TransformerXL, TransformerXLConfig,
                             TransformerXLTrainStep)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .word2vec import NGramLM, SkipGramNCE

__all__ = ["GPTConfig", "GPTBlock", "GPTLanguageModel",
           "dense_causal_attention", "BertConfig", "BertModel",
           "BertForPretraining", "MLMHeadOutput", "pretraining_loss",
           "bert_base_config", "bert_large_config",
           "Seq2SeqConfig", "TransformerSeq2Seq", "BasicBlock",
           "BottleneckBlock", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnext50_32x4d", "ErnieConfig",
           "ErnieModel", "ErnieForPretraining", "knowledge_mask",
           "LMConfig", "LSTMLanguageModel", "CRNNCTC", "SentimentBiLSTM",
           "SRLBiLSTMCRF", "NGramLM", "SkipGramNCE", "LeNet", "MobileNetV1",
           "MobileNetV2", "mobilenet_v1", "mobilenet_v2", "VGG", "vgg11",
           "vgg13", "vgg16", "vgg19", "SSDLite", "Generator",
           "Discriminator", "GANTrainStep", "TransformerXLConfig",
           "TransformerXL", "TransformerXLTrainStep", "RecommenderSystem",
           "DeepFM"]
